"""The port's packages export the reference's public names.

For each of ``repro.{dist,train,models,kernels,configs}``, every public
name (the module's names without a leading underscore) has a counterpart
in ``repro_torch`` of the same name, or the stand-in named here, where
the port differs by design; nothing waits any longer (tensor
parallelism brought ``TPCtx`` and ``make_dims``, and
``repro_torch.models`` exports ``Dims``, ``head_mask`` and ``pad_to``
beside them, as the reference's ``models.layers`` has them).
``input_specs`` gives meta-device tensors of the reference's shapes and dtypes for all four
input shapes, a VLM's image embeddings among them.
"""
import importlib
import types

import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro_torch import configs
from repro_torch.configs import shapes

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

PACKAGES = ("dist", "train", "models", "kernels", "configs")
# reference name -> the port's counterpart, where they differ by design
STAND_INS = {
    "train": {"TrainState": "Trainer", "init_train_state": "Trainer",
              "make_train_step": "Trainer"},
    "dist": {"MeshTransport": "ProcessGroupTransport",
             "Transport": "StackedTransport"},
    "kernels": {"quantize_pallas": "quantize_cuda",
                "dequantize_pallas": "dequantize_cuda",
                "bucket_stats_pallas": "bucket_stats_cuda"},
}
# reference names the port does not have yet (none since --tp)
WAITING: dict[str, set] = {}
# the tensor-parallel primitives repro_torch.models exports
TP_NAMES = ("TPCtx", "Dims", "make_dims", "head_mask", "pad_to")


def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_")
            and not (isinstance(getattr(mod, n), types.ModuleType)
                     and n not in ("checkpoint", "faults", "fsdp", "sync",
                                   "transport"))
            and n not in ("annotations",)}


@pytest.mark.parametrize("package", PACKAGES)
def test_every_public_name_has_a_counterpart(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    stand_in = STAND_INS.get(package, {})
    missing = []
    for name in sorted(_public(ref) - WAITING.get(package, set())):
        if not hasattr(port, stand_in.get(name, name)):
            missing.append(name)
    assert not missing, f"repro_torch.{package} lacks {missing}"


def test_models_export_the_tensor_parallel_primitives():
    from repro.models import layers as jlayers
    from repro_torch import models
    from repro_torch.models import layers
    for name in TP_NAMES:
        assert getattr(models, name) is getattr(layers, name)
        assert hasattr(jlayers, name), name
    cfg = configs.get_smoke_config("granite-3-2b")
    jcfg = jconfigs.get_smoke_config("granite-3-2b")
    for tp in (1, 2, 4):
        assert tuple(models.make_dims(cfg, tp)) == tuple(
            jlayers.make_dims(jcfg, tp))
    assert models.pad_to(509, 4) == jlayers.pad_to(509, 4) == 512


def test_stand_ins_are_what_they_stand_for():
    from repro_torch.dist import ProcessGroupTransport, StackedTransport
    from repro_torch.kernels import ops
    assert issubclass(ProcessGroupTransport, StackedTransport)
    assert {n: callable(getattr(ops, n)) for n in (
        "quantize_op", "dequantize_op", "bucket_stats_op")} == {
        "quantize_op": True, "dequantize_op": True, "bucket_stats_op": True}
    for name in ("ARCH_NAMES", "get_config", "get_smoke_config"):
        assert hasattr(configs, name)
    assert configs.ARCH_NAMES == jconfigs.ARCH_NAMES


_DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama-3.2-vision-11b"])
def test_input_specs_match_reference(shape, arch):
    assert shapes.SHAPES[shape] == shapes.InputShape(
        **vars(jshapes.SHAPES[shape]))
    want = jshapes.input_specs(jconfigs.get_config(arch),
                               jshapes.SHAPES[shape])
    got = shapes.input_specs(configs.get_config(arch),
                             shapes.SHAPES[shape])
    assert got.keys() == want.keys()
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == spec.shape, k
        assert got[k].dtype == _DTYPES[spec.dtype.type], k
    assert ("vision" in got) == (arch == "llama-3.2-vision-11b")
