"""trace/train_profile.py reads each hand-written kernel's time from the
profiler by substrings of the kernel's name (``KERNEL_SYMBOLS``). Each
substring must occur in the name of a ``__global__`` function of the CUDA
source that chip_smoke.py names for that kernel, so a rename in ops/csrc
cannot leave a profile column reading 0 without an error. On the CPU:
the sources are only read."""

import ctypes
import re

import pytest

import chip_smoke
from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.trace import decode_profile, train_profile

# Profile rows that are passes of a kernel of chip_smoke.KERNELS rather
# than a kernel of their own: the source they come from.
PASS_SOURCES = {"xent_bwd_dl": chip_smoke.LOSS_SOURCE}

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def source_of(key: str) -> str:
    if key in chip_smoke.KERNELS:
        return chip_smoke.KERNELS[key]["source"]
    return PASS_SOURCES[key]


def global_names(source: str) -> list:
    path = _build.CSRC / source.rsplit("/", 1)[-1]
    return _GLOBAL.findall(path.read_text())


CASES = [(key, symbol) for key, symbols in train_profile.KERNEL_SYMBOLS.items()
         for symbol in symbols]


@pytest.mark.parametrize("key,symbol", CASES)
def test_profile_symbol_names_a_kernel_of_its_source(key, symbol):
    names = global_names(source_of(key))
    assert any(symbol in name for name in names), (key, symbol, names)


@pytest.mark.parametrize("key", sorted(train_profile.KERNEL_SYMBOLS))
def test_every_profile_row_has_a_source_under_csrc(key):
    source = source_of(key)
    assert source.startswith("batch_shipyard_tpu_torch/ops/csrc/")
    assert (_build.CSRC / source.rsplit("/", 1)[-1]).is_file()


def test_global_pattern_finds_every_kernel():
    """The pattern sees every ``__global__`` function of every source, so
    a kernel it missed cannot hide a stale symbol."""
    for path in sorted(_build.CSRC.glob("*.cu")):
        text = path.read_text()
        assert len(_GLOBAL.findall(text)) == text.count("__global__"), path


# Lines of an -Xptxas -v report as nvcc 12.8 prints them for sm_90a.
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN45_INTERNAL_e2e53_18_flash_attention_cu_c8c10a4622flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_NS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_INTERNAL_e2e53_18_flash_attention_cu_c8c10a4622flash_fwd_wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_NS_4ArgsE
    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117tf32_round_kernelIfEEvPKT_Pfx' for 'sm_90a'
ptxas info    : Used 20 registers, 16 bytes smem, 380 bytes cmem[0]
"""


@pytest.mark.parametrize("mangled,short", [
    ("_ZN45_INTERNAL_e2e53_18_flash_attention_cu_c8c10a4622flash_fwd_"
     "wgmma_kernelILi64EEEv14CUtensorMap_stS1_S1_NS_4ArgsE",
     "flash_fwd_wgmma_kernel<64>"),
    ("_ZN45_INTERNAL_e2e53_18_flash_attention_cu_c8c10a464fp3225flash_bwd_"
     "dkdv_fma_kernelILi128EEEvNS_4ArgsE", "flash_bwd_dkdv_fma_kernel<128>"),
    ("_ZN12_GLOBAL__N_117tf32_round_kernelIfEEvPKT_Pfx", "tf32_round_kernel"),
    ("_Z3foov", "_Z3foov"),
])
def test_kernel_short_name(mangled, short):
    assert chip_smoke.kernel_short_name(mangled) == short


def test_ptxas_report_reads_registers_smem_and_spills():
    assert chip_smoke.ptxas_report(PTXAS_LOG) == {
        "flash_fwd_wgmma_kernel<64>": {"registers": 168, "smem": 0,
                                       "spill_stores": 8,
                                       "spill_loads": 12},
        "tf32_round_kernel": {"registers": 20, "smem": 16},
    }


@pytest.mark.parametrize("kv_cache", sorted(decode_profile.ATTENTION_KERNEL))
def test_decode_profile_attention_kernel_names_a_kernel(kv_cache):
    """trace/decode_profile.py's attention share reads the kernel named
    here; it must be a ``__global__`` function of decode_attention.cu, so
    a rename cannot leave that share reading 0."""
    names = global_names(chip_smoke.DECODE_SOURCE)
    symbol = decode_profile.ATTENTION_KERNEL[kv_cache]
    assert any(name.startswith(symbol) for name in names), (symbol, names)


@pytest.mark.parametrize("mangled,short", [
    ("_ZN12_GLOBAL__N_127paged_decode_cluster_kernelI13__nv_bfloat16aLi64E"
     "EEv14CUtensorMap_stS1_NS_11ClusterArgsE",
     "paged_decode_cluster_kernel<bf16, int8, 64>"),
    ("_ZN12_GLOBAL__N_127paged_decode_cluster_kernelI13__nv_bfloat16S1_Li6"
     "4EEEv14CUtensorMap_stS2_NS_11ClusterArgsE",
     "paged_decode_cluster_kernel<bf16, bf16, 64>"),
    ("_ZN12_GLOBAL__N_127paged_decode_cluster_kernelIffLi128EEEv14CUtensor"
     "Map_stS1_NS_11ClusterArgsE",
     "paged_decode_cluster_kernel<fp32, fp32, 128>"),
    ("_ZN12_GLOBAL__N_127dense_decode_cluster_kernelI13__nv_bfloat16Li64EE"
     "Ev14CUtensorMap_stS2_NS_11ClusterArgsE",
     "dense_decode_cluster_kernel<bf16, 64>"),
    ("_ZN12_GLOBAL__N_127dense_decode_cluster_kernelIfLi128EEEv14CUtensorMap"
     "_stS1_NS_11ClusterArgsE", "dense_decode_cluster_kernel<fp32, 128>"),
    # The speculative draft's depth.
    ("_ZN12_GLOBAL__N_127dense_decode_cluster_kernelI13__nv_bfloat16Li16EE"
     "Ev14CUtensorMap_stS2_NS_11ClusterArgsE",
     "dense_decode_cluster_kernel<bf16, 16>"),
    ("_ZN12_GLOBAL__N_127paged_decode_cluster_kernelI13__nv_bfloat16aLi16E"
     "EEv14CUtensorMap_stS1_NS_11ClusterArgsE",
     "paged_decode_cluster_kernel<bf16, int8, 16>"),
    ("_ZN2mm24int8_matmul_wgmma_kernelE14CUtensorMap_stS0_S0_NS_4ArgsE",
     "int8_matmul_wgmma_kernel"),
])
def test_paged_kernel_name(mangled, short):
    assert chip_smoke.paged_kernel_name(mangled) == short


@pytest.mark.parametrize("switch", ["BS_PAGED", "BS_DENSE"])
def test_decode_depth_switches_instantiate_every_supported_depth(switch):
    """K6/K7 (BS_PAGED) and K8 (BS_DENSE) are instantiated at exactly the
    head depths the wrappers accept (ops/paged_attention.SUPPORTED_DEPTHS,
    which the speculative draft's 16 joined), each case launching its own
    depth: a depth the wrappers pass with no case would fail every launch
    with cudaErrorInvalidValue."""
    from batch_shipyard_tpu_torch.ops import paged_attention
    text = (_build.CSRC / "decode_attention.cu").read_text()
    cases = re.findall(rf"case (\d+): return {switch}\((\d+)\);", text)
    assert all(a == b for a, b in cases), cases
    assert sorted(int(a) for a, _ in cases) == sorted(
        paged_attention.SUPPORTED_DEPTHS)
    assert 16 in paged_attention.SUPPORTED_DEPTHS


def test_ring_copy_kernels_keep_the_profile_names():
    """K12, K13 and K14 launch one copy kernel per Copy of their plans
    (ops/ring_collectives.py COPY_KERNELS picks the __global__): the
    profile's K12, K13 and K14 rows must still find those kernels by
    name."""
    from batch_shipyard_tpu_torch.ops import ring_collectives
    names = global_names(chip_smoke.RING_SOURCE)
    for key in ("ring_permute", "ring_all_gather", "ring_reduce_scatter"):
        (symbol,) = train_profile.KERNEL_SYMBOLS[key]
        assert symbol in names, (key, names)
        assert key in ring_collectives.COPY_KERNELS
    assert sorted(ring_collectives.COPY_KERNELS.values()) == [0, 1, 2]


# C parameter types of the ``extern "C"`` entry points and the ctypes
# types that may stand for them: a data pointer may pass as c_void_p.
_C_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
              "unsigned long long": ctypes.c_ulonglong,
              "float": ctypes.c_float}
_C_ENTRY = re.compile(r"^(int|long long|const char\*) (bs_\w+)\(([^)]*)\)\s*\{",
                      re.M)


def _ctypes_for(param: str) -> tuple:
    """The ctypes types a C parameter declaration may be bound as."""
    decl = re.sub(r"\bconst\b", "", param).replace("*", " * ").split()
    stars = decl.count("*")
    base = " ".join(w for w in decl[:-1] if w != "*")
    if stars == 0:
        return (_C_SCALARS[base],)
    # void* is c_void_p itself; any other T* is POINTER(T).
    typed = ctypes.c_void_p if base == "void" else _C_SCALARS.get(base)
    for _ in range(stars - (base == "void")):
        typed = None if typed is None else ctypes.POINTER(typed)
    return (ctypes.c_void_p, typed) if stars == 1 else (typed,)


def c_entry_points(name: str) -> dict:
    text = (_build.CSRC / f"{name}.cu").read_text()
    text = text[text.index('extern "C" {'):]
    return {fn: (ret, [p for p in params.split(",") if p.strip()])
            for ret, fn, params in _C_ENTRY.findall(text)}


SIGNATURE_CASES = [(name, fn) for name, fns in _build.SIGNATURES.items()
                   for fn in fns]


@pytest.mark.parametrize("name,fn", SIGNATURE_CASES)
def test_ctypes_signature_matches_the_c_entry_point(name, fn):
    """Each entry of _build.SIGNATURES binds the C function of that name
    argument by argument: a parameter added to or dropped from the source
    (K16 lost its scratch pointer) must change the ctypes list too, or the
    later arguments would arrive in the wrong places."""
    entries = c_entry_points(name)
    assert fn in entries, (name, fn, sorted(entries))
    ret, params = entries[fn]
    argtypes, restype = _build.SIGNATURES[name][fn]
    assert len(argtypes) == len(params), (fn, params)
    for param, bound in zip(params, argtypes):
        assert bound in _ctypes_for(param), (fn, param, bound)
    assert restype == {"int": ctypes.c_int, "long long": ctypes.c_longlong,
                       "const char*": ctypes.c_char_p}[ret]


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_every_c_entry_point_has_a_signature(name):
    assert sorted(c_entry_points(name)) == sorted(_build.SIGNATURES[name])
