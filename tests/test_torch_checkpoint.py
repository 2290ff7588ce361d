"""Checkpoints of the port's trainer, and the launcher's periodic save and
auto-resume, on the CPU.

Everything here is exact: a checkpoint round trip gives back the same
bits, and a run resumed from a checkpoint takes the same steps as one
that never stopped (the rounding generator's state is part of the
checkpoint, so it draws the same uniforms).  The launcher's flags follow
the reference's semantics: resume at the saved step + 1, save when
(t + 1) % save_every == 0 and at the last step, keep the newest three.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.schemes import QuantScheme
from repro_torch.launch import train
from repro_torch.models.transformer import Model
from repro_torch.train import checkpoint
from repro_torch.train.data import DataConfig, Pipeline
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_step import TrainConfig, Trainer

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)


def _arrays():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(3, 4, generator=g),
            "b": torch.arange(5, dtype=torch.int64),
            "rng": torch.Generator().manual_seed(3).get_state(),
            "s": torch.tensor(7)}


def test_save_restore_roundtrip(tmp_path):
    path = str(tmp_path / "x" / "ck.npz")
    arrays = _arrays()
    checkpoint.save(path, arrays)
    assert not os.path.exists(path + ".tmp")
    like = {k: torch.zeros_like(v) for k, v in arrays.items()}
    got = checkpoint.restore(path, like)
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_restore_names_missing_extra_and_mismatched_keys(tmp_path):
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, _arrays())
    like = _arrays()
    del like["a"]
    like["c"] = torch.zeros(2)
    with pytest.raises(ValueError, match=r"missing keys \['c'\].*extra "
                                         r"keys \['a'\]"):
        checkpoint.restore(path, like)
    like = _arrays()
    like["a"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="mismatch at a"):
        checkpoint.restore(path, like)


def test_save_step_prunes_to_the_newest_three(tmp_path):
    d = str(tmp_path)
    assert checkpoint.latest_checkpoint(d) is None
    assert checkpoint.restore_latest(d, _arrays()) is None
    for step in (1, 3, 5, 7, 9):
        arrays = _arrays()
        arrays["s"] = torch.tensor(step)
        assert checkpoint.save_step(d, step, arrays) == \
            checkpoint.step_path(d, step)
    assert checkpoint.list_checkpoints(d) == [5, 7, 9]
    step, got = checkpoint.restore_latest(d, _arrays())
    assert step == 9 and int(got["s"]) == 9
    assert checkpoint.latest_checkpoint(d) == (9, checkpoint.step_path(d, 9))


def test_save_with_retry(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.npz")
    real, calls = checkpoint.save, []

    def flaky(p, arrays):
        calls.append(p)
        if len(calls) < 3:
            raise OSError("disk hiccup")
        real(p, arrays)

    monkeypatch.setattr(checkpoint, "save", flaky)
    checkpoint.save_with_retry(path, _arrays(), backoff_s=0.0)
    assert len(calls) == 3 and os.path.exists(path)
    calls.clear()
    monkeypatch.setattr(checkpoint, "save",
                        lambda p, a: (_ for _ in ()).throw(OSError("full")))
    with pytest.raises(OSError, match="full"):
        checkpoint.save_with_retry(path, _arrays(), attempts=2,
                                   backoff_s=0.0)


def _trainer(compress="ef", sync="two_phase", integrity=True):
    cfg = configs.get_config("paper-proxy")
    model = Model(cfg, device="cpu", seed=0)
    return Trainer(model, TrainConfig(
        scheme=QuantScheme(name="alq", bits=3, bucket_size=1024),
        optim=OptimConfig(name="adamw", lr=2e-3, weight_decay=0.0),
        sync_mode=sync, update_milestones=(1,), update_every=0, workers=4,
        compress=compress, integrity=integrity), seed=0)


PIPE = Pipeline(DataConfig(kind="markov", vocab_size=256, seq_len=32,
                           global_batch=8))


def test_resumed_trainer_takes_the_same_steps(tmp_path):
    straight = _trainer()
    losses = [straight.train_step(PIPE.batch(t, "cpu"))["loss"]
              for t in range(5)]
    first = _trainer()
    for t in range(3):
        first.train_step(PIPE.batch(t, "cpu"))
    checkpoint.save_step(str(tmp_path), 2, first.state_arrays())
    resumed = _trainer()
    step, arrays = checkpoint.restore_latest(str(tmp_path),
                                             resumed.state_arrays())
    resumed.load_state_arrays(arrays)
    assert step == 2 and resumed.step == 3
    assert resumed.compress_state.step == 3
    assert resumed.scheme_state.num_updates == 1
    after = [resumed.train_step(PIPE.batch(t, "cpu"))["loss"]
             for t in range(3, 5)]
    assert after == losses[3:]
    for k, v in straight.state_arrays().items():
        assert torch.equal(resumed.state_arrays()[k], v), k


def _launch(tmp_path, steps, *extra):
    return train.run(train.parse_args([
        "--device", "cpu", "--workers", "4", "--batch", "8", "--seq", "16",
        "--steps", str(steps), "--update-at", "1", "--sync", "two_phase",
        "--compress", "ef", "--integrity", *extra]))


def test_launcher_saves_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    straight = _launch(tmp_path, 6)
    capsys.readouterr()
    _launch(tmp_path, 4, "--ckpt-dir", ck, "--save-every", "3")
    assert checkpoint.list_checkpoints(ck) == [2, 3]
    first = capsys.readouterr().out
    assert "resumed" not in first
    step0 = [ln for ln in first.splitlines() if ln.startswith("step    0")]
    assert " |e|=" in step0[0] and " kept=1.00" in step0[0]
    res = _launch(tmp_path, 6, "--ckpt-dir", ck, "--save",
                  str(tmp_path / "params.npz"))
    out = capsys.readouterr().out
    assert f"resumed step 3 from {checkpoint.step_path(ck, 3)}" in out
    assert [h["step"] for h in res["history"]] == [4, 5]
    assert [h["loss"] for h in res["history"]] == \
        [h["loss"] for h in straight["history"][4:]]
    assert checkpoint.list_checkpoints(ck) == [2, 3, 5]
    params = checkpoint.restore(str(tmp_path / "params.npz"),
                                {"params": res["trainer"].model.flat})
    assert torch.equal(params["params"], straight["trainer"].model.flat)
    assert all(np.isfinite(h["corrupt_fraction"]) and
               h["corrupt_fraction"] == 0.0 for h in res["history"])


@pytest.mark.parametrize("extra", [
    ["--codec", "entropy"], ["--codec", "mixed_width", "--widths", "2,4,3"],
    ["--micro", "2"]])
def test_launcher_resumes_with_each_codec(tmp_path, extra):
    """The codecs are stateless (the entropy table is a function of the
    scheme), so a resumed launch takes the straight run's steps."""
    def launch(steps, *more):
        return train.run(train.parse_args([
            "--device", "cpu", "--workers", "2", "--batch", "4", "--seq",
            "16", "--steps", str(steps), "--update-at", "1", *extra, *more]))

    ck = str(tmp_path / "ck")
    straight = launch(4)
    launch(2, "--ckpt-dir", ck)
    res = launch(4, "--ckpt-dir", ck)
    assert [h["step"] for h in res["history"]] == [2, 3]
    for a, b in zip(res["history"], straight["history"][2:]):
        assert (a["loss"], a["comm_bits_per_coord"]) == \
            (b["loss"], b["comm_bits_per_coord"])
    assert torch.equal(res["trainer"].model.flat,
                       straight["trainer"].model.flat)


def test_launcher_refuses_topk_with_integrity():
    from repro import compress as jcompress
    from repro.core.codec import make_codec as jmake_codec
    from repro.core.schemes import QuantScheme as JScheme
    jscheme = JScheme(bits=3, bucket_size=1024)
    with pytest.raises(ValueError) as ref_err:
        jcompress.make_algorithm("topk", jscheme,
                                 codec=jmake_codec(jscheme, integrity=True))
    with pytest.raises(ValueError) as port_err:
        train.run(train.parse_args([
            "--device", "cpu", "--workers", "2", "--steps", "1",
            "--compress", "topk", "--integrity"]))
    assert str(port_err.value) == str(ref_err.value)
