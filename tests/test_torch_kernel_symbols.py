"""trace/train_profile.py reads each hand-written kernel's time from the
profiler by substrings of the kernel's name (``KERNEL_SYMBOLS``). Each
substring must occur in the name of a ``__global__`` function of the CUDA
source that chip_smoke.py names for that kernel, so a rename in ops/csrc
cannot leave a profile column reading 0 without an error. On the CPU:
the sources are only read."""

import re

import pytest

import chip_smoke
from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.trace import train_profile

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
