"""How the port's kernels are built and launched, on the CPU:
``kernels/cuda.py`` decides in plain Python which layout, threads,
elements a thread and shared memory a bucket kernel (quantize,
bucket_stats) gets, binds each C entry point through ``ctypes``, builds
each library under a name that hashes its sources, and reads the
compiler's ``-Xptxas -v`` report.  The kernels themselves run only on the
card (``test_torch_cuda.py``).
"""
import re
import stat

import pytest
import torch

from repro_torch.kernels import cuda

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

ALIGNED = (0x7F0000000000, 0x7F0000100000, 0x7F0000200000)
BUCKET_CUH = (cuda.CSRC / "bucket.cuh").read_text()


@pytest.mark.parametrize("bs", sorted(cuda.REG_SHAPES))
@pytest.mark.parametrize("itemsize", [4, 2])
def test_repo_bucket_sizes_stay_in_registers(bs, itemsize):
    launch = cuda.bucket_launch(bs, itemsize, ALIGNED)
    assert launch.layout == "regs"
    assert launch.threads * launch.ept == bs
    assert launch.ept % (16 // itemsize) == 0  # whole 16-byte vectors
    assert launch.threads % 32 == 0 and launch.threads <= 1024
    assert launch.smem == 0


def test_the_scheme_and_launcher_bucket_sizes_are_register_resident():
    """QuantScheme's default bucket (8192) and the launcher's (1024)."""
    from repro_torch.core.schemes import QuantScheme
    from repro_torch.launch import train
    assert QuantScheme().bucket_size in cuda.REG_SHAPES
    assert train.parse_args([]).bucket in cuda.REG_SHAPES


@pytest.mark.parametrize("offset", [1, 2, 4, 8, 12])
@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("bs", sorted(cuda.REG_SHAPES))
@pytest.mark.parametrize("itemsize", [4, 2])
def test_vector_loads_need_every_pointer_16_byte_aligned(offset, which, bs,
                                                         itemsize):
    ptrs = list(ALIGNED)
    ptrs[which] += offset
    launch = cuda.bucket_launch(bs, itemsize, ptrs)
    assert launch.layout == "smem"
    assert launch.ept == 0


@pytest.mark.parametrize("bs", [7, 100, 128, 1000, 4097, 8190, 16384, 32768,
                                57084, 57085, 65536, 1 << 20])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_shared_memory_stays_within_a_block(bs, itemsize):
    launch = cuda.bucket_launch(bs, itemsize, ALIGNED)
    assert launch.threads % 32 == 0 and 32 <= launch.threads <= 256
    if launch.layout == "smem":
        assert bs * itemsize + 16 <= launch.smem
        assert launch.smem + cuda.STATIC_SMEM <= cuda.SMEM_LIMIT == 232_448
    else:
        assert launch.layout == "stream" and launch.smem == 0
        assert bs * itemsize + 16 + cuda.STATIC_SMEM > cuda.SMEM_LIMIT


def test_launch_args_follow_the_c_interface():
    launch = cuda.BucketLaunch("smem", 256, smem=4096)
    assert launch.args() == (1, 256, 0, 4096)
    regs = cuda.BucketLaunch("regs", 512, 16)
    assert regs.args() == (0, 512, 16, 0)


C_TYPES = {"long long": cuda._LL, "int": cuda._I}


@pytest.mark.parametrize("name", sorted(cuda.KERNELS))
def test_ctypes_signature_matches_the_c_entry_point(name):
    """Each C entry point's parameters, as declared in its source, are
    the argument types ``kernel()`` binds: pointers, long long, int."""
    source, symbol, argtypes = cuda.KERNELS[name]
    src = (cuda.CSRC / f"{source}.cu").read_text()
    decl = re.search(r'extern "C" int %s\(([^)]*)\)' % symbol, src)
    assert decl is not None
    params = [" ".join(p.split()[:-1]) for p in decl.group(1).split(",")]
    want = [cuda._P if "*" in p else C_TYPES[p] for p in params]
    assert list(argtypes) == want
    assert params[-1] == "void*"  # the stream, which launch() appends


def test_c_and_python_name_the_same_layouts_and_shapes():
    """bucket.cuh's Layout codes and with_reg_shape's shapes are the ones
    kernels/cuda.py hands it."""
    enum = re.search(r"enum Layout \{([^}]*)\}", BUCKET_CUH).group(1)
    codes = {name.strip(): int(v) for name, v in
             re.findall(r"k(\w+) = (\d+)", enum)}
    assert codes == {"Regs": 0, "Smem": 1, "Stream": 2}
    assert cuda.LAYOUT_CODES == {"regs": 0, "smem": 1, "stream": 2}
    compiled = {(int(t), int(e)) for t, e in
                re.findall(r"threads == (\d+) && ept == (\d+)", BUCKET_CUH)}
    assert compiled == set(cuda.REG_SHAPES.values())
    for bs, (t, e) in cuda.REG_SHAPES.items():
        assert t * e == bs and e % 8 == 0  # whole vectors of f32 and bf16


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/ that cuda.py builds from, into a build directory
    of its own."""
    src = tmp_path / "csrc"
    src.mkdir()
    for f in cuda.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda, "CSRC", src)
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "build")
    return src


@pytest.mark.parametrize("name", sorted(cuda.SOURCES))
def test_an_edited_source_gets_a_new_library(csrc_copy, name):
    before = {k: cuda.library_path(k) for k in cuda.SOURCES}
    assert before == {k: cuda.library_path(k) for k in cuda.SOURCES}
    assert len(set(before.values())) == len(cuda.SOURCES)
    with open(csrc_copy / f"{name}.cu", "a") as f:
        f.write("// edited\n")
    after = {k: cuda.library_path(k) for k in cuda.SOURCES}
    assert {k for k in cuda.SOURCES if after[k] != before[k]} == {name}
    assert after[name].parent == cuda.BUILD_DIR
    assert after[name].name.startswith(f"{name}-")


def test_every_kernel_lives_in_a_source_of_its_own_library():
    """dequantize.cu holds two kernels, attention.cu three; every source
    is built once."""
    assert cuda.SOURCES == ("quantize", "dequantize", "bucket_stats",
                            "attention")
    assert {k: v[0] for k, v in cuda.KERNELS.items()} == {
        "quantize": "quantize", "dequantize": "dequantize",
        "dequantize_mean": "dequantize", "bucket_stats": "bucket_stats",
        "attention_fwd": "attention", "attention_bwd_dq": "attention",
        "attention_bwd_dkv": "attention"}
    for source in cuda.SOURCES:
        assert (cuda.CSRC / f"{source}.cu").exists()


def test_an_edited_header_rebuilds_every_kernel(csrc_copy):
    before = {k: cuda.library_path(k) for k in cuda.SOURCES}
    with open(csrc_copy / "common.cuh", "a") as f:
        f.write("// edited\n")
    after = {k: cuda.library_path(k) for k in cuda.SOURCES}
    assert all(after[k] != before[k] for k in cuda.SOURCES)


def _fake_nvcc(path, rc=0):
    """A stand-in for nvcc that prints a ptxas report and writes the file
    named after -o (or fails with ``rc``)."""
    path.write_text(
        "#!/bin/sh\n"
        f"cat <<'EOF'\n{PTXAS}EOF\n"
        f"[ {rc} -ne 0 ] && exit {rc}\n"
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_compiles_only_what_is_missing_and_keeps_the_report(
        csrc_copy, tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path / "nvcc")
    monkeypatch.setattr(cuda, "nvcc_path", lambda: nvcc)
    seconds = cuda.build()
    assert set(seconds) == set(cuda.SOURCES)
    for name in cuda.SOURCES:
        assert cuda.library_path(name).exists()
        assert cuda.ptxas_report(name) == cuda.parse_ptxas(PTXAS)
    assert (cuda.ptxas_report("dequantize_mean")
            == cuda.ptxas_report("dequantize"))
    assert cuda.build() == {}
    assert not list(cuda.BUILD_DIR.glob("*.tmp"))


def test_a_failed_build_raises_with_the_compilers_output(
        csrc_copy, tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path / "nvcc", rc=2)
    monkeypatch.setattr(cuda, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed for quantize.cu"
                       "(.|\n)*Used 96 registers"):
        cuda.build(("quantize",))
    assert not cuda.library_path("quantize").exists()


def test_nvcc_is_looked_up_under_cuda_home_then_on_the_path(
        tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.nvcc_path()
    on_path = _fake_nvcc(tmp_path / "nvcc")
    assert cuda.nvcc_path() == on_path
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    in_home = _fake_nvcc(home / "bin" / "nvcc")
    monkeypatch.setenv("CUDA_HOME", str(home))
    assert cuda.nvcc_path() == in_home


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5repro13quantize_regsIfaLi0ELi3ELi512ELi16EEEvPKT_PKfS5_PT0_Pfi' for 'sm_90a'
ptxas info    : Function properties for _ZN5repro13quantize_regsIfaLi0ELi3ELi512ELi16EEEvPKT_PKfS5_PT0_Pfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 224 bytes smem, 404 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5repro9stats_anyIfLi0ELb1EEEvPKT_PfS4_S4_i' for 'sm_90a'
ptxas info    : Function properties for _ZN5repro9stats_anyIfLi0ELb1EEEvPKT_PfS4_S4_i
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 392 cmem[0]
"""


def test_ptxas_report_is_read_per_entry_point():
    rep = cuda.parse_ptxas(PTXAS)
    q = rep["_ZN5repro13quantize_regsIfaLi0ELi3ELi512ELi16EEEvPKT_PKfS5_PT0_"
            "Pfi"]
    assert q == dict(registers=96, smem=224, stack=0, spill_stores=0,
                     spill_loads=0)
    s = rep["_ZN5repro9stats_anyIfLi0ELb1EEEvPKT_PfS4_S4_i"]
    assert s == dict(registers=40, smem=0, stack=8, spill_stores=4,
                     spill_loads=4)
