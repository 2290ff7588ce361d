"""The child processes of the process-group tests: one worker a process.

Not a test module (pytest collects ``test_*.py`` only), and it imports no
JAX.  The same functions run the port's transport, sync engine and
trainer over a ``ProcessGroupTransport`` in each child and over the
stacked transport in the parent, which compares the two:

  * ``spawn_main`` is the body of each process that
    ``torch.multiprocessing`` spawns (gloo, a ``file://`` store): it runs
    every case of ``SYNC_CASES`` and ``TRAIN_CASES`` and the transport
    case, and saves its rank's results;
  * ``python tests/torch_dist_worker.py launch OUT ARGV...`` under
    ``torch.distributed.run`` runs the training launcher's ``run`` and
    writes each rank's losses and parameter digest to OUT.
"""
from __future__ import annotations

import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.compress import CompressState, make_algorithm
from repro_torch.core.codec import make_codec
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist import sync
from repro_torch.dist.faults import FaultModel, faulty
from repro_torch.launch import mesh, train
from repro_torch.models.transformer import Model
from repro_torch.train.data import DataConfig, Pipeline
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_step import TrainConfig, Trainer

# one thread a process: the ranks share the host's cores
torch.set_num_threads(1)

D, BS = 5000, 256      # the sync cases' gradient width and buckets
FAULT_STEP = 5
# name -> the case: sync mode, codec, integrity words, compression,
# a level update first, wire faults
SYNC_CASES = {
    "all_gather": dict(mode="all_gather"),
    "all_gather_integrity": dict(mode="all_gather", integrity=True),
    "two_phase": dict(mode="two_phase"),
    "two_phase_integrity": dict(mode="two_phase", integrity=True),
    "ef_two_phase": dict(mode="two_phase", compress="ef"),
    "topk_all_gather": dict(mode="all_gather", compress="topk"),
    "entropy_all_gather": dict(mode="all_gather", codec="entropy"),
    "entropy_two_phase": dict(mode="two_phase", codec="entropy",
                              integrity=True),
    "mixed_width_two_phase": dict(mode="two_phase", codec="mixed_width"),
    "level_update": dict(mode="all_gather", update=True),
    "fp32": dict(mode="fp32"),
    "faults_all_gather": dict(mode="all_gather", integrity=True,
                              fault=dict(flip_prob=1e-2, seed=3)),
    "faults_two_phase": dict(mode="two_phase", integrity=True,
                             fault=dict(flip_prob=1e-2, seed=3)),
}
# three steps of paper-proxy's SMOKE config, a level update at step 1
TRAIN_CASES = {
    "ef": dict(sync_mode="two_phase", compress="ef", integrity=True),
    "micro": dict(sync_mode="all_gather", microbatches=2),
}
TRAIN_STEPS, TRAIN_SEQ = 3, 32


SCHEME = QuantScheme(name="alq", bits=3, bucket_size=BS)


def algorithm_of(case: dict):
    """The case's compression algorithm around its codec (the stateless
    passthrough when it compresses nothing)."""
    name = case.get("compress", "plain")
    codec = make_codec(SCHEME, case.get("codec", "uniform"),
                       integrity=case.get("integrity", False))
    return make_algorithm(name, SCHEME,
                          codec=None if name == "topk" else codec)


def _rows(x, local):
    return None if x is None else [x[w] for w in local]


def run_case(case: dict, inputs: dict, transport) -> dict:
    """One synchronization of ``inputs['grads']``'s rows of the workers
    ``transport`` holds: the aggregate, the local own round trips (or,
    compressed, the local residual rows), the levels and every metric."""
    local = transport.local_workers()
    algo = algorithm_of(case)
    flats = inputs["grads"][local].clone()
    state = SCHEME.init_state("cpu")
    if case.get("update"):
        state = sync.maybe_update_levels(flats, SCHEME, state, True,
                                         transport=transport)
    if "fault" in case:
        transport = faulty(transport, FaultModel(**case["fault"]),
                           FAULT_STEP)
    u, u2 = _rows(inputs["u"], local), _rows(inputs["u2"], local)
    out = {"levels": state.levels}
    if algo.stateful:
        comp = CompressState(residual=inputs["residual"][local].clone(),
                             step=1)
        out["out"], comp, m = sync.compressed_allreduce(
            flats, SCHEME, state, algo, comp, mode=case["mode"],
            transport=transport, u=u, u2=u2)
        out["residual"] = comp.residual
    else:
        out["out"], out["own"], m = sync.quantized_allreduce(
            flats, SCHEME, state, mode=case["mode"], transport=transport,
            codec=algo.codec, u=u, u2=u2, return_own=True)
    out["metrics"] = m._asdict()
    return out


def transport_case(transport, M: int) -> dict:
    """The collectives themselves on each worker's seeded payloads: int32
    words, a (M, 7) all_to_all payload, float32 scalars, uint8 rows."""
    def payloads(w):
        g = torch.Generator().manual_seed(40 + w)
        return (torch.randint(-2**31, 2**31 - 1, (33,), dtype=torch.int32,
                              generator=g),
                torch.randint(-2**31, 2**31 - 1, (M, 7), dtype=torch.int32,
                              generator=g),
                torch.rand((), generator=g),
                torch.randint(0, 256, (9,), dtype=torch.uint8, generator=g))

    local = [payloads(w) for w in transport.local_workers()]
    return {"all_gather": transport.all_gather([p[0] for p in local]),
            "all_to_all": transport.all_to_all([p[1] for p in local]),
            "scalars": transport.all_gather([p[2] for p in local]),
            "bytes": transport.all_gather([p[3] for p in local]),
            "mean_psum": transport.mean_psum(
                torch.stack([p[2] for p in local])[:, None])}


def train_case(case: dict, transport, M: int) -> dict:
    """Three steps of paper-proxy's SMOKE config (a level update at step
    1, per-worker generators, no uniforms given): every step's metrics,
    the final parameters and the whole ``state_arrays``."""
    cfg = configs.get_smoke_config("paper-proxy")
    model = Model(cfg, device="cpu", seed=0)
    k = case.get("microbatches", 1)
    tcfg = TrainConfig(
        scheme=QuantScheme(name="alq", bits=3, bucket_size=1024),
        optim=OptimConfig(name="adamw", lr=1e-3, weight_decay=0.0),
        update_milestones=(1,), update_every=0, workers=M, **case)
    trainer = Trainer(model, tcfg, seed=0, transport=transport)
    pipe = Pipeline(DataConfig(kind="uniform", vocab_size=cfg.vocab_size,
                               seq_len=TRAIN_SEQ, global_batch=2 * k * M))
    history = [trainer.train_step(pipe.batch(t, "cpu"))
               for t in range(TRAIN_STEPS)]
    return {"history": history, "params": model.flat.detach().clone(),
            "state": trainer.state_arrays()}


def spawn_main(rank: int, world: int, path: str) -> None:
    """A spawned rank: join the gloo group through ``path``'s file store,
    run every case and save this rank's results to ``path``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    _, transport = mesh.init_process_group(
        "gloo", "cpu", init_method=f"file://{os.path.join(path, 'store')}")
    try:
        inputs = torch.load(os.path.join(path, "inputs.pt"))
        results = {"rank": transport.rank(),
                   "local": transport.local_workers(),
                   "transport": transport_case(transport, world),
                   "sync": {name: run_case(case, inputs[name], transport)
                            for name, case in SYNC_CASES.items()},
                   "train": {name: train_case(case, transport, world)
                             for name, case in TRAIN_CASES.items()}}
        torch.save(results, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch_main(out: str, argv: list[str]) -> None:
    """The launcher's ``run`` under torchrun; each rank writes its losses
    and the digest of its final parameters to ``out``."""
    try:
        res = train.run(train.parse_args(argv))
        rank = dist.get_rank()
        with open(os.path.join(out, f"launch_rank{rank}.json"), "w") as f:
            json.dump({"loss": [h["loss"] for h in res["history"]],
                       "step": [h["step"] for h in res["history"]],
                       "digest": train.params_digest(
                           res["trainer"].model.flat)}, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] != "launch":
        sys.exit(f"unknown mode {sys.argv[1]!r}")
    launch_main(sys.argv[2], sys.argv[3:])
