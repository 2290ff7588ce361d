"""The harness's layout, weights and reference held to what they were
before the layer kinds moved into ``layers/``: ``frozen.json`` was
written by ``record()`` on the commit before that move.  For the
benchmark's two configurations and the ``attn`` and ``rwkv`` test ones,
every leaf's (name, shape, offset, draw, fan_in), d and the model FLOPs'
parameter count; for the test ones, the SHA-256 of the float32 weights
of seed 7 on the CPU, and the reference's loss (its float32 bits) and
gradient (the SHA-256 of its float32 bytes) on 2 rows of 64 tokens."""
import hashlib
import json
import struct

import pytest
import torch

from conftest import BENCH, ROOT, TINY
from harness import shapes, weights
from reference.model import Reference
from reference.step import leaf_views

FROZEN = json.loads((BENCH / "tests" / "frozen.json").read_text())
SEED = 7


def _configs() -> dict[str, dict]:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = {c["name"]: json.loads((ROOT / c["file"]).read_text())["model"]
           for c in spec["configs"] if c["name"] in ("qwen3-0.6b",
                                                     "rwkv6-7b-2l")}
    out.update({f"tiny-{k}": TINY[k] for k in ("attn", "rwkv")})
    return out


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


def layout(m: dict) -> dict:
    return {"leaves": [[lf.name, list(lf.shape), lf.offset, lf.draw,
                        lf.fan_in] for lf in shapes.leaves(m)],
            "coordinates": shapes.coordinates(m),
            "param_count": shapes.param_count(m)}


def reference_bits(m: dict) -> dict:
    gen = torch.Generator().manual_seed(SEED)
    toks = torch.randint(0, m["vocab_size"], (2, 65), generator=gen)
    p = weights.make(m, SEED, "cpu")
    w = _sha(p)
    p.requires_grad_()
    loss = Reference(m).loss(leaf_views(p, shapes.leaves(m)), toks[:, :-1],
                             toks[:, 1:])
    loss.backward()
    return {"weights_sha256": w,
            "loss_bits": struct.pack("<f", loss.item()).hex(),
            "grad_sha256": _sha(p.grad)}


def record() -> dict:
    out = {}
    for name, m in _configs().items():
        out[name] = layout(m)
        if name.startswith("tiny-"):
            out[name].update(reference_bits(m))
    return out


@pytest.mark.parametrize("name", sorted(_configs()))
def test_layout_as_frozen(name):
    assert layout(_configs()[name]) == {
        k: FROZEN[name][k] for k in ("leaves", "coordinates", "param_count")}


@pytest.mark.parametrize("name", ["tiny-attn", "tiny-rwkv"])
def test_weights_and_reference_as_frozen(name):
    got = reference_bits(_configs()[name])
    assert got == {k: FROZEN[name][k] for k in got}
