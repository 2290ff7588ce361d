"""The benchmark's CPU tests: run from the root of the repo as
``python -m pytest perfbench/tests``; the card tests (marker ``cuda``) skip
without a card."""
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import cells, traffic as traffic_lib  # noqa: E402

torch.set_num_threads(1)

# a few layers of each layer kind under layers/ at test widths
TINY = {
    "attn": {"name": "tiny-attn", "arch_type": "dense", "num_layers": 2,
             "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
             "head_dim": 16, "d_ff": 128, "vocab_size": 256,
             "qk_norm": True, "rope_theta": 1e6, "norm_eps": 1e-6,
             "compute_dtype": "bfloat16", "param_dtype": "float32"},
    "rwkv": {"name": "tiny-rwkv", "arch_type": "ssm", "num_layers": 2,
             "d_model": 128, "num_heads": 2, "num_kv_heads": 2,
             "d_ff": 256, "vocab_size": 256, "layer_pattern": "rwkv",
             "rwkv_head_dim": 64, "norm_eps": 1e-5,
             "compute_dtype": "bfloat16", "param_dtype": "float32"},
    # sliding attention of window 16 (at S = 64), every 2nd slot full
    "window": {"name": "tiny-window", "arch_type": "dense", "num_layers": 4,
               "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
               "head_dim": 16, "d_ff": 128, "vocab_size": 256,
               "qk_norm": True, "rope_theta": 1e6, "norm_eps": 1e-6,
               "attn_kind": "sliding", "window": 16, "full_attn_every": 2,
               "compute_dtype": "float32", "param_dtype": "float32"},
}


def tiny_traffic(sync_mode="all_gather", bucket=256, rows=2, seq=64):
    """The cells' jobs at test sizes: two_phase as the cell runs it, with
    error feedback and checksum words."""
    scheme = "alq" if sync_mode != "fp32" else "fp32"
    two_phase = sync_mode == "two_phase"
    return traffic_lib.Traffic(
        name=f"tiny-{sync_mode}", workers=4, rows_per_worker=rows,
        seq_len=seq, tokens="uniform",
        scheme={"name": scheme, "bits": 3, "bucket_size": bucket},
        sync_mode=sync_mode, codec="uniform",
        compress="ef" if two_phase else "plain", integrity=two_phase,
        optimizer={"name": "adamw", "lr": 1e-4, "weight_decay": 0.0,
                   "b1": 0.9, "b2": 0.95, "eps": 1e-8},
        update_milestones=(0, 100, 2000), update_every=10000)


def tiny_cell(kind="attn", sync_mode="all_gather", limits=None):
    return cells.Cell(
        name=f"tiny-{kind}.{sync_mode}", chips=1,
        config={"model": TINY[kind]}, traffic=tiny_traffic(sync_mode),
        limits=limits or {}, end_to_end=[], per_layer=[])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
