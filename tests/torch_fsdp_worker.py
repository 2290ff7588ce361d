"""The child processes of the FSDP process-group tests: one worker a
process, gloo on the CPU.

Not a test module (pytest collects ``test_*.py`` only), and it imports no
JAX.  ``spawn_main`` is the body of each process that
``torch.multiprocessing`` spawns through a ``file://`` store: it runs the
reduce-scatter cases (``rs_case``, quantized and float32, the gather's
error feedback) and the trainer cases (``train_case``) over a
``ProcessGroupTransport`` and saves its rank's results; the parent runs
the same functions over the stacked transport and compares.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.compress import make_algorithm
from repro_torch.core.codec import make_codec
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist import fsdp
from repro_torch.launch import mesh
from repro_torch.models.transformer import Model
from repro_torch.train.data import DataConfig, Pipeline
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_step import TrainConfig, Trainer

# one thread a process: the ranks share the host's cores
torch.set_num_threads(1)

BS = 128                 # buckets of the reduce-scatter cases
RS_BUCKETS = 48          # buckets of their flat vector (before padding)
SCHEME = QuantScheme(name="alq", bits=3, bucket_size=BS)
# name -> the codec of the case ('fp32': the float32 mean)
RS_CASES = ("uniform", "entropy", "mixed_width", "fp32")
ARCH = "qwen3-0.6b"      # the trainer cases' SMOKE config
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BS = 3, 32, 256
# name -> (fsdp_sync, micro-batches)
TRAIN_CASES = {"quantized": ("quantized", 1), "micro": ("quantized", 2),
               "fp32": ("fp32", 1)}


def rs_inputs(M: int) -> dict:
    """Each worker's cotangent rows and EF residual rows, (M, Lp)."""
    g = torch.Generator().manual_seed(100 + M)
    _, nb = fsdp.chunk_plan(RS_BUCKETS * BS, BS, M)
    Lp = nb * BS
    scale = torch.exp(torch.randn((M, 1), generator=g))
    return {"rows": torch.randn((M, Lp), generator=g) * 1e-2 * scale,
            "residual": torch.randn((M, Lp), generator=g) * 1e-3}


def rs_case(name: str, rows: torch.Tensor, transport, residual=None):
    """One reduce-scatter of the local workers' rows: (L, Lp/M) shard
    means (and the new residual rows), with the keys ``SeedKey(7)``
    folded with each worker."""
    keys = [fsdp.SeedKey(7).fold(w) for w in transport.local_workers()]
    levels = SCHEME.init_levels("cpu")
    if name == "fp32":
        return transport.reduce_scatter_mean(rows)
    return fsdp._quantized_reduce_scatter(
        rows, levels, keys, transport=transport,
        codec=make_codec(SCHEME, name), residual=residual)


def gather_ef_case(inputs: dict, transport) -> dict:
    """The EF gather of one worker a process: forward, then the backward
    of a cotangent; the shard's gradient and the new residual."""
    w = transport.rank()
    M = transport.size()
    Lp = inputs["rows"].shape[1]
    algo = make_algorithm("ef", SCHEME)
    gather = fsdp.make_gather(SCHEME, transport=transport, algorithm=algo)
    full = torch.arange(Lp, dtype=torch.float32) * 1e-4
    shard = full.view(M, -1)[w:w + 1].clone().requires_grad_()
    residual = inputs["residual"][w].clone().requires_grad_()
    out = gather(shard, SCHEME.init_levels("cpu"), fsdp.SeedKey(7).fold(w),
                 residual)
    out.backward(inputs["rows"][w])
    return {"full": out.detach(), "shard_grad": shard.grad,
            "residual": residual.grad}


def train_case(name: str, transport, M: int) -> dict:
    """Three steps of the SMOKE config's FSDP trainer (a level update at
    step 1): every step's metrics and ``state_arrays``."""
    sync, k = TRAIN_CASES[name]
    cfg = configs.get_smoke_config(ARCH)
    scheme = QuantScheme(name="alq", bits=3, bucket_size=TRAIN_BS)
    model = Model(cfg, device="cpu", seed=0, param_mode="fsdp", dp=M,
                  transport=transport, fsdp_scheme=scheme, fsdp_sync=sync)
    tcfg = TrainConfig(
        scheme=scheme, optim=OptimConfig(name="adamw", lr=1e-3,
                                         weight_decay=0.0),
        update_milestones=(1,), update_every=0, workers=M, microbatches=k)
    trainer = Trainer(model, tcfg, seed=0)
    pipe = Pipeline(DataConfig(kind="uniform", vocab_size=cfg.vocab_size,
                               seq_len=TRAIN_SEQ, global_batch=2 * k * M))
    history = [trainer.train_step(pipe.batch(t, "cpu"))
               for t in range(TRAIN_STEPS)]
    return {"history": history, "state": trainer.state_arrays()}


def spawn_main(rank: int, world: int, path: str) -> None:
    """A spawned rank: join the gloo group through ``path``'s file store,
    run every case and save this rank's results to ``path``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    _, transport = mesh.init_process_group(
        "gloo", "cpu", init_method=f"file://{os.path.join(path, 'store')}")
    try:
        inputs = rs_inputs(world)
        mine = inputs["rows"][rank:rank + 1]
        results = {"rank": rank, "rs": {
            name: rs_case(name, mine, transport) for name in RS_CASES}}
        results["rs_ef"] = rs_case(
            "uniform", mine, transport,
            residual=inputs["residual"][rank:rank + 1])
        results["gather_ef"] = gather_ef_case(inputs, transport)
        results["train"] = {name: train_case(name, transport, world)
                            for name in TRAIN_CASES}
        torch.save(results, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
