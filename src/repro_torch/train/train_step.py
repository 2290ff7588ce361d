"""Adaptive quantized data-parallel train step (Algorithm 1, end to end)
for M data-parallel workers: all M on one device over the stacked
transport, or one a process over a ``ProcessGroupTransport``.

Per step:
  1. each worker the process holds runs forward and backward on its
     contiguous rows of the global batch (and of its ``vision``
     embeddings, where the batch has them), and its gradient lands in its
     row of one (L, d) buffer of the parameters' dtype, L the local
     workers (the model's parameters and gradients are flat views, in the
     reference's ravel order); with ``microbatches=k`` the rows run as k
     consecutive micro-batches whose gradients accumulate in that row, in
     the parameters' dtype as in the reference;
  2. on the update schedule: bucket statistics per worker, the merged
     mixture, and the ALQ/AMQ level update (lines 2-4);
  3. ENCODE -> collective -> DECODE -> average (lines 6-9) through
     ``dist.sync.compressed_allreduce``, with the configured compression
     algorithm around the wire (the error-feedback residual is formed in
     place in the gradient rows and updated worker by worker); bfloat16
     rows go to the wire as float32, whose values they hold exactly, as
     the reference's quantizer reads them, and the decoded aggregate is
     float32; the plain mean (``fp32``, or an unquantized scheme) keeps
     the rows' dtype, as the reference's ``psum`` does;
  4. one SGD-momentum / AdamW update of the flat parameters from the
     aggregate, with moments in the aggregate's dtype (as the reference's
     are after its first step) and parameters rounded back to theirs.

With an FSDP model (``Model(param_mode="fsdp")``) the step is the
reference's FSDP branch: each worker's forward gathers the slots it runs,
and the gathers' backward reduce-scatters the gradient to the worker
mean (quantized with the current levels and the worker's key for the
step, ``fold(fold(key, step), w)``); with M > 1 workers stacked in one
process that reduce-scatter runs over their stacked rows once every
worker's backward has run (stage ``reduce_scatter``), a micro-batch at a
time.  ``final_norm`` takes the plain mean, the levels adapt from slot
0's shard of the gradient, and the optimizer updates the local shards.

With a tensor-parallel model (``Model(tp_ctx=...)``) this process is one
rank of a (data x model) grid: the trainer's transport is its data group,
so the wire, the level fit and the FSDP collectives run over the data
group, each model rank on its own flat, with its own levels (the
reference merges the level statistics over the data axes only).  Every
worker's rounding is seeded by its data rank alone (``worker_seed``, as
the reference folds only the data rank into the step's key), so the
model ranks of a data rank draw the same uniforms.  The metrics are this
rank's: the launcher reports model rank 0's, as the reference's
replicated out-specs give device 0's.

Handed a clock other than ``timing.NO_CLOCK``, a step is recorded
(``timing.recording``): the ``step`` span with its ``tokens``, each
worker's ``forward`` and ``backward`` a micro-batch (device spans; the
model's ``embed``, ``block``, ``loss`` and ``recompute`` inside them),
the wire's spans (``dist.sync``) and ``optimizer``; the clock's marks
are kept as the step's stages and reach the clock handed in.

``Trainer.state_arrays`` / ``load_state_arrays`` give its whole state as
named tensors for ``train.checkpoint`` (under FSDP in the global layout;
at tp > 1 the parameters and moments in the reference's global layout,
gathered over the model group, see ``state_arrays``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import timing
from repro_torch.compress import make_algorithm
from repro_torch.core.codec import make_codec
from repro_torch.core.schemes import QuantScheme, SchemeState
from repro_torch.dist.fsdp import SeedKey, reduce_scatter
from repro_torch.dist.sync import (
    compressed_allreduce, maybe_update_levels, quantized_allreduce)
from repro_torch.dist.transport import StackedTransport
from repro_torch.models.layers import tp_all_gather
from repro_torch.models.transformer import (
    Model, final_norm_slice, from_global, fsdp_views, to_global)
from repro_torch.numerics import reciprocal, worker_mean
from repro_torch.timing import NO_CLOCK
from .optim import OptimConfig, OptState, apply_updates, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    scheme: QuantScheme = QuantScheme()
    optim: OptimConfig = OptimConfig()
    sync_mode: str = "all_gather"       # fp32 | all_gather | two_phase
    update_milestones: tuple = (100, 2000)
    update_every: int = 10_000          # additionally every k steps
    workers: int = 1                    # M logical data-parallel workers
    microbatches: int = 1               # gradient accumulation per worker
    # wire codec: 'uniform' | 'mixed_width' | 'entropy[:base]' (the
    # entropy-coded wire with the gaussian-prior table; its bits/coord
    # are then the measured coded volume)
    codec: str = "uniform"
    # per-bucket scheme-bits pattern of codec='mixed_width', tiled over
    # the buckets; empty = the budget-neutral (bits-1, bits+1) cycle
    mixed_width_pattern: tuple = ()
    # compression algorithm around the codec (repro_torch.compress):
    # 'plain' | 'ef[:warmup_steps]' | 'topk[:k]'
    compress: str = "plain"
    # per-bucket checksum words on the wire; corrupt buckets are excluded
    integrity: bool = False


def _make_algo(tcfg: TrainConfig):
    if not tcfg.scheme.quantized:
        return None
    # None = the scheme's uniform codec; only another codec or an
    # integrity plan is passed explicitly (make_algorithm refuses a codec
    # for 'topk', which owns its SparseCodec)
    codec = None
    if tcfg.codec != "uniform" or tcfg.integrity:
        codec = make_codec(tcfg.scheme, tcfg.codec, tcfg.mixed_width_pattern,
                           integrity=tcfg.integrity)
    return make_algorithm(tcfg.compress, tcfg.scheme, codec=codec)


# domain separation of the per-worker rounding seeds
_FOLD_WORKER = 0x57A7


def worker_seed(seed: int, w: int) -> int:
    """The seed of worker w's rounding generator: (seed, w) -> a 63-bit
    int, the counterpart of the reference's ``fold_in(key, rank)``."""
    ss = np.random.SeedSequence([seed, _FOLD_WORKER, w])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def is_update_step(tcfg: TrainConfig, step: int) -> bool:
    if step in tcfg.update_milestones:
        return True
    return tcfg.update_every > 0 and step > 0 and step % tcfg.update_every == 0


class Trainer:
    """Owns the training state of one model for the workers its process
    holds (``transport.local_workers()``; all ``tcfg.workers`` on the
    default stacked transport): their (L, d) gradient rows, the optimizer
    moments, the scheme state, the compression state (their (L, d)
    error-feedback residual rows of a stateful algorithm), their rounding
    generators and the step counter.

    Worker w's stochastic rounding draws from its own generator on the
    model's device, seeded with ``worker_seed(seed, w)``, so a worker
    draws the same uniforms whichever process holds it.  Under FSDP it
    draws from ``key`` (``dist.fsdp.SeedKey(seed)`` by default) folded
    with the step and the worker, as the reference's ``base_key``.
    """

    def __init__(self, model: Model, tcfg: TrainConfig, *, seed: int = 0,
                 transport: StackedTransport | None = None, key=None):
        self.model = model
        self.tcfg = tcfg
        self.fsdp = model.param_mode == "fsdp"
        if self.fsdp:
            if transport is not None and transport is not model.transport:
                raise ValueError("an FSDP model trains over its own "
                                 "transport")
            transport = model.transport
            algo = _make_algo(tcfg)
            if algo is not None and algo.stateful:
                raise NotImplementedError(
                    "stateful compression on the FSDP path is wired at "
                    "the gather level (dist.fsdp.make_gather("
                    "algorithm=...)), not through TrainConfig.compress")
        self.key = SeedKey(seed) if key is None else key
        if transport is None:
            transport = StackedTransport(tcfg.workers)
        if transport.size() != tcfg.workers:
            raise ValueError(f"a transport of {transport.size()} workers "
                             f"for {tcfg.workers}")
        self.transport = transport
        self.local = transport.local_workers()
        dev = model.flat.device
        # the meta device (the dry run) carries shapes: no host reads, and
        # no generators (a draw there allocates its shape)
        meta = dev.type == "meta"
        if model.tp > 1 and not meta:
            # every worker's forward issues the model group's collectives,
            # so the group's ranks must run as many forwards, in one order
            held = tp_all_gather(model.ctx, torch.tensor(
                [len(self.local)], device=dev)).view(-1).tolist()
            if len(set(held)) > 1:
                raise ValueError(f"the model group's ranks hold {held} data "
                                 "workers; each must hold as many")
        self.grads = torch.zeros((len(self.local), model.d),
                                 dtype=model.flat.dtype, device=dev)
        # the wire decodes to float32; the plain mean keeps the rows' dtype
        # (FSDP's aggregates take the parameters')
        self.plain_mean = (self.fsdp or tcfg.sync_mode == "fp32"
                           or not tcfg.scheme.quantized)
        self.opt = init_opt_state(
            tcfg.optim, model.flat,
            model.flat.dtype if self.plain_mean else torch.float32)
        self.scheme_state = tcfg.scheme.init_state(dev)
        self.algo = None if self.fsdp else _make_algo(tcfg)
        self.compress_state = None
        if self.algo is not None and self.algo.stateful:
            self.compress_state = self.algo.init_state(len(self.local),
                                                       model.d, dev)
        self.step = 0
        self.generators = [
            None if meta else
            torch.Generator(device=dev).manual_seed(worker_seed(seed, w))
            for w in self.local]

    def train_step(self, batch: dict[str, torch.Tensor], *,
                   u: Sequence[torch.Tensor] | None = None,
                   u2: Sequence[torch.Tensor] | None = None,
                   clock=NO_CLOCK) -> dict[str, float]:
        """One step on a global batch (ids, labels of shape (B, S), and
        for a VLM optionally ``vision`` of shape (B, S_img, d_model)).

        ``u`` and ``u2`` optionally give each local worker's uniforms
        (see ``quantized_allreduce``).  Returns the step's metrics, the
        same in every process: the loss is the mean of all M workers'
        losses, per-worker wire metrics are worker 0's, the residual norm
        the workers' mean.
        """
        return {k: v.item() if isinstance(v, torch.Tensor) else v
                for k, v in self.step_tensors(batch, u=u, u2=u2,
                                              clock=clock).items()}

    def step_tensors(self, batch: dict[str, torch.Tensor], *,
                     u: Sequence[torch.Tensor] | None = None,
                     u2: Sequence[torch.Tensor] | None = None,
                     clock=NO_CLOCK) -> dict:
        """``train_step``'s device work: its metrics, those the step
        computes as 0-d tensors on the model's device, unread.  The dry
        run (``launch.dryrun``) drives it on the meta device."""
        if clock is NO_CLOCK:
            return self._step(batch, u, u2, clock)
        with timing.recording(self.model.flat.device, clock=clock,
                              model=self.model, step=self.step) as clock:
            return self._step(batch, u, u2, clock)

    def _step(self, batch, u, u2, clock) -> dict:
        tcfg, model = self.tcfg, self.model
        rows, k, mb = self._split(batch)
        timing.count("tokens", len(self.local) * rows
                     * batch["ids"].shape[1])
        if self.fsdp:
            return self._fsdp_step(batch, rows, k, mb, clock)
        vision = batch.get("vision")
        losses = []
        for i, w in enumerate(self.local):
            g = self.grads[i]
            g.zero_()
            model.attach_grads(g)
            loss = 0.0
            for j, lo in enumerate(range(w * rows, (w + 1) * rows, mb)):
                with timing.span("forward", device=True, worker=w, micro=j):
                    part = model.loss(
                        batch["ids"][lo:lo + mb], batch["labels"][lo:lo + mb],
                        None if vision is None else vision[lo:lo + mb])
                # accumulates into the worker's row
                with timing.span("backward", device=True, worker=w, micro=j):
                    part.backward()
                loss = loss + part.detach()
            if k > 1:   # the reference's g / k, as XLA compiles it
                g.mul_(reciprocal(k))
                loss = loss * reciprocal(k)
            losses.append(loss)
        clock.mark("grad")
        # float32 rows are the same tensor
        rows = self.grads if self.plain_mean else self.grads.float()
        self.scheme_state = maybe_update_levels(
            rows, tcfg.scheme, self.scheme_state,
            is_update_step(tcfg, self.step), transport=self.transport,
            clock=clock)
        if self.algo is None:   # fp32 / super_sgd: the plain mean
            synced, m = quantized_allreduce(
                rows, tcfg.scheme, self.scheme_state,
                mode=tcfg.sync_mode, transport=self.transport, clock=clock)
        else:
            synced, self.compress_state, m = compressed_allreduce(
                rows, tcfg.scheme, self.scheme_state, self.algo,
                self.compress_state, mode=tcfg.sync_mode,
                transport=self.transport, u=u, u2=u2,
                generator=self.generators, clock=clock)
        with timing.span("optimizer"):
            grad_norm = torch.sqrt(torch.sum(synced * synced))
            self.opt = apply_updates(tcfg.optim, model.flat, synced,
                                     self.opt)
            del synced, rows
        clock.mark("optimizer")
        self.step += 1
        # every worker's loss, in worker order, in every process
        losses = self.transport.all_gather(losses)
        return {
            "loss": worker_mean(losses),
            "grad_norm": grad_norm,
            "comm_bits_per_coord": m.comm_bits_per_coord,
            "quant_error": m.quant_error[0],
            "reduce_bits_per_coord": m.reduce_bits_per_coord,
            "broadcast_bits_per_coord": m.broadcast_bits_per_coord,
            "entropy_bits_per_coord": m.entropy_bits_per_coord,
            "residual_norm": worker_mean(m.residual_norm),
            "kept_fraction": m.kept_fraction,
            "corrupt_fraction": m.corrupt_fraction[0],
            "excluded_workers": m.excluded_workers[0],
        }

    def _split(self, batch) -> tuple[int, int, int]:
        """(rows a worker, micro-batches, rows a micro-batch)."""
        M, k = self.tcfg.workers, self.tcfg.microbatches
        B = batch["ids"].shape[0]
        if B % M:
            raise ValueError(f"global batch {B} does not split over {M} "
                             "workers")
        rows = B // M
        if rows % k:
            raise ValueError(f"{rows} rows a worker do not split into {k} "
                             "micro-batches")
        return rows, k, rows // k

    # ---- FSDP ------------------------------------------------------------

    def _fsdp_views(self, buf: torch.Tensor) -> dict[str, torch.Tensor]:
        return fsdp_views(buf, self.model.fsdp_entries,
                          self.transport.size(), len(self.local))

    def _reduce_deposits(self, levels, keys, synced) -> None:
        """The stacked workers' reduce-scatter: every sharded entry's M
        cotangent rows (left in ``self.grads`` by the backwards) -> their
        mean, added into ``synced``; the rows' entries are zeroed."""
        model = self.model
        views = self._fsdp_views(synced)       # an entry: (count, M, Lp/M)
        off = 0
        for e in model.fsdp_entries:
            if e.meta is None:
                off += e.Lp
                continue
            out = views[e.name]
            for g in range(e.count):
                r = self.grads[:, off + g * e.Lp:off + (g + 1) * e.Lp]
                mean = reduce_scatter(
                    r, levels, [key.fold(e.fold) for key in keys],
                    transport=self.transport, codec=model.fsdp_codec,
                    quantized=model.fsdp_quantized)
                out[g] += mean.to(out.dtype)
                r.zero_()
            off += e.count * e.Lp

    def _fsdp_step(self, batch, rows, k, mb, clock) -> dict[str, float]:
        tcfg, model = self.tcfg, self.model
        levels = self.scheme_state.levels
        # the reference's base_key: fold(fold(rng, step), data rank)
        keys = [self.key.fold(self.step).fold(w) for w in self.local]
        deposit = len(self.local) > 1
        vision = batch.get("vision")
        self.grads.zero_()
        synced = (torch.zeros_like(self.grads[0]) if deposit
                  else self.grads[0])
        losses = [0.0] * len(self.local)
        for j in range(k):
            for i, w in enumerate(self.local):
                model.attach_grads(self.grads[i])
                lo = w * rows + j * mb
                with timing.span("forward", device=True, worker=w, micro=j):
                    part = model.loss(
                        batch["ids"][lo:lo + mb], batch["labels"][lo:lo + mb],
                        None if vision is None else vision[lo:lo + mb],
                        sync_ctx=(levels, keys[i]))
                with timing.span("backward", device=True, worker=w, micro=j):
                    part.backward()
                losses[i] = losses[i] + part.detach()
            if deposit:
                clock.mark("grad")
                self._reduce_deposits(levels, keys, synced)
                clock.mark("reduce_scatter")
        clock.mark("grad")
        # the local final_norm gradients, then their plain mean
        fn = torch.stack([self._fsdp_views(g)["final_norm"]
                          for g in self.grads])
        if k > 1:
            synced.mul_(reciprocal(k))
            fn = fn * reciprocal(k)
            losses = [x * reciprocal(k) for x in losses]
        sv = self._fsdp_views(synced)
        # the reference's grad_norm: worker 0's local gradient leaves
        sq = torch.stack([sum(torch.sum(
            (fn[i] if e.meta is None else sv[e.name][:, i]).float() ** 2)
            for e in model.fsdp_entries) for i in range(len(self.local))])
        # gathered, then one mean: the same additions in every form
        sv["final_norm"].copy_(
            worker_mean(self.transport.all_gather(list(fn))))
        slot0 = torch.stack([sv["slots.0"][:, i].reshape(-1)
                             for i in range(len(self.local))])
        self.scheme_state = maybe_update_levels(
            slot0.float(), tcfg.scheme, self.scheme_state,
            is_update_step(tcfg, self.step), transport=self.transport,
            clock=clock)
        del slot0
        with timing.span("optimizer"):
            self.opt = apply_updates(tcfg.optim, model.flat, synced,
                                     self.opt)
        del synced, sv
        clock.mark("optimizer")
        self.step += 1
        losses = self.transport.all_gather(losses)
        grad_norm = torch.sqrt(self.transport.all_gather(list(sq))[0])
        # the wire the model's gathers ship, as the reference reports it
        quantized = tcfg.scheme.quantized
        wire = (model.fsdp_codec.nominal_bits_per_coord if quantized
                else 32.0)
        return {
            "loss": worker_mean(losses),
            "grad_norm": grad_norm,
            "comm_bits_per_coord": 2.0 * wire if quantized else 32.0,
            "quant_error": 0.0,
            "reduce_bits_per_coord": wire,
            "broadcast_bits_per_coord": wire if quantized else 0.0,
            "entropy_bits_per_coord": self.scheme_state.entropy_bits,
            "residual_norm": 0.0,
            "kept_fraction": 1.0,
            "corrupt_fraction": 0.0,
            "excluded_workers": 0.0,
        }

    # ---- checkpointing ---------------------------------------------------

    def _all_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The local workers' (L, ...) rows -> all M workers' (M, ...) on
        ``local``'s device; a collective when other processes hold
        workers."""
        if len(self.local) == self.transport.size():
            return local
        dev = self.model.flat.device
        return self.transport.all_gather(
            [r.to(dev) for r in local]).to(local.device)

    # the flats that state_arrays converts to the global layout at tp > 1
    _FLATS = ("params", "opt.mu", "opt.nu")

    def _tp_layout(self) -> dict:
        m = self.model
        return {"fsdp": (m.fsdp_scheme.bucket_size, self.transport.size())
                if self.fsdp else None}

    def state_arrays(self) -> dict[str, torch.Tensor]:
        """The whole training state as named tensors: flat parameters,
        optimizer moments and count, the scheme state, the step, every
        worker's rounding generator state (``worker_rng``, (M, state
        bytes)) and the compression state (``compress.residual``, all M
        workers' rows).  The same in every process, and the same as a
        stacked trainer's of the same M: a collective when other
        processes hold workers, so every process calls it.

        At tp > 1 it is also gathered over the model group: ``params``
        and the moments in the reference's global layout
        (``transformer.to_global``: sharded leaves stacked along their tp
        axis, ``final_norm`` model rank 0's, as the reference saves it),
        with every rank's ``final_norm`` besides (``<name>.final_norm``,
        (tp, d)), and every other entry stacked over the model ranks
        (tp, ...): the replicated leaves and the levels train per model
        rank, and a resumed run continues each rank's own."""
        out = self._local_state_arrays()
        ctx = self.model.ctx
        if ctx.tp == 1:
            return out
        kw = self._tp_layout()
        fn = final_norm_slice(self.model.cfg, ctx.tp, **kw)
        for k in list(out):
            every = tp_all_gather(ctx, out[k].to(self.model.flat.device))
            if k in self._FLATS:
                out[k] = to_global(every, self.model.cfg, **kw).cpu()
                out[f"{k}.final_norm"] = every[:, fn].cpu()
            else:
                out[k] = every.to(out[k].device)
        return out

    def _local_state_arrays(self) -> dict[str, torch.Tensor]:
        glob = (self.model.global_flat if self.fsdp
                else lambda t: t)     # FSDP: the global layout
        out = {"params": glob(self.model.flat.detach()),
               "opt.mu": glob(self.opt.mu),
               "opt.count": torch.tensor(self.opt.count),
               "step": torch.tensor(self.step),
               "worker_rng": self._all_rows(torch.stack(
                   [g.get_state() for g in self.generators]))}
        if self.opt.nu is not None:
            out["opt.nu"] = glob(self.opt.nu)
        for f in SchemeState._fields:
            out[f"scheme.{f}"] = torch.as_tensor(getattr(self.scheme_state,
                                                         f))
        if self.compress_state is not None:
            out["compress.residual"] = self._all_rows(
                self.compress_state.residual)
            out["compress.step"] = torch.tensor(self.compress_state.step)
        return out

    def load_state_arrays(self, arrays: dict[str, torch.Tensor]) -> None:
        """Restore what ``state_arrays`` gave (shapes as this trainer's),
        keeping the local workers' rows of the per-worker arrays (at
        tp > 1 this model rank's shards and entries)."""
        ctx = self.model.ctx
        if ctx.tp > 1:
            kw = self._tp_layout()
            fn = final_norm_slice(self.model.cfg, ctx.tp, **kw)
            mine = {}
            for k, v in arrays.items():
                if k in self._FLATS:
                    flat = from_global(v, self.model.cfg, ctx.tp, ctx.rank,
                                       **kw).clone()
                    flat[fn] = arrays[f"{k}.final_norm"][ctx.rank]
                    mine[k] = flat
                elif not k.endswith(".final_norm"):
                    mine[k] = v[ctx.rank]
            arrays = mine
        local = (self.model.local_rows if self.fsdp else lambda t: t)
        with torch.no_grad():
            self.model.flat.copy_(local(arrays["params"]))
            self.opt.mu.copy_(local(arrays["opt.mu"]))
            if self.opt.nu is not None:
                self.opt.nu.copy_(local(arrays["opt.nu"]))
        self.opt = OptState(self.opt.mu, self.opt.nu,
                            int(arrays["opt.count"]))
        dev = self.model.flat.device
        self.scheme_state = SchemeState(
            levels=arrays["scheme.levels"].to(dev),
            multiplier=arrays["scheme.multiplier"].to(dev),
            num_updates=int(arrays["scheme.num_updates"]),
            entropy_bits=arrays["scheme.entropy_bits"].to(dev))
        self.step = int(arrays["step"])
        for i, w in enumerate(self.local):
            # a state must own its storage: set_state reads a row view
            # from the start of the stacked storage
            self.generators[i].set_state(arrays["worker_rng"][w].clone())
            if self.compress_state is not None:
                self.compress_state.residual[i].copy_(
                    arrays["compress.residual"][w])
        if self.compress_state is not None:
            self.compress_state = self.compress_state._replace(
                step=int(arrays["compress.step"]))
