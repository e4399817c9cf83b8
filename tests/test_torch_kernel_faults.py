"""chip_smoke.py's planted kernel faults against the CUDA sources, on the
CPU (no nvcc): each anchor occurs exactly once in its source and inside
the body of the ``__global__`` function it names, and its substitution
changes the text, so an edit of a kernel cannot leave a fault that
silently patches nothing."""

import pytest

import chip_smoke
from batch_shipyard_tpu_torch.ops import _build

CASES = [(name, i) for name, faults in chip_smoke.FAULTS.items()
         for i in range(len(faults))]


@pytest.mark.parametrize("name,index", CASES)
def test_fault_anchor_sits_once_in_its_kernel(name, index):
    kernel, anchor, fault, outputs = chip_smoke.FAULTS[name][index]
    text = (_build.CSRC / f"{name}.cu").read_text()
    assert text.count(anchor) == 1, (kernel, anchor)
    start, end = chip_smoke.kernel_body(text, kernel)
    at = text.index(anchor)
    assert start <= at and at + len(anchor) <= end, (kernel, anchor)
    assert fault != anchor and outputs
    planted = chip_smoke.plant_faults(name)
    assert planted.count(fault) >= 1 and planted != text


def test_kernel_body_matches_braces():
    """The body ends at the kernel's own closing brace, past braces in
    nested blocks, comments and string literals."""
    text = ('__global__ void __launch_bounds__(32) k(int a) {\n'
            '  if (a) { asm("{ .reg .pred p; }"); }  // } stray\n'
            '}\n__global__ void other() {}\n')
    start, end = chip_smoke.kernel_body(text, "k")
    assert text[start] == "{" and text[end - 1] == "}"
    assert text[end:].startswith("\n__global__ void other")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.kernel_body(text, "missing")


def test_plant_faults_refuses_a_missing_anchor(monkeypatch):
    kernel, anchor, fault, outs = chip_smoke.FAULTS["fused_norm"][0]
    monkeypatch.setitem(chip_smoke.FAULTS, "fused_norm",
                        ((kernel, anchor + " /* gone */", fault, outs),))
    with pytest.raises(chip_smoke.SmokeFailure, match="not once"):
        chip_smoke.plant_faults("fused_norm")


@pytest.mark.parametrize("index", range(len(chip_smoke.DECODE_FAULTS)))
def test_one_fault_build_plants_only_its_fault(index):
    """check_kernels reads each decode fault from a build of its own:
    plant_faults(name, only=i) changes that anchor and no other."""
    text = (_build.CSRC / "decode_attention.cu").read_text()
    planted = chip_smoke.plant_faults("decode_attention", only=index)
    for i, (_, anchor, fault, _) in enumerate(chip_smoke.DECODE_FAULTS):
        assert (anchor in planted) == (i != index)
        assert (fault in planted) == (i == index)
    assert len(planted) - len(text) == (
        len(chip_smoke.DECODE_FAULTS[index][2]) -
        len(chip_smoke.DECODE_FAULTS[index][1]))


def test_decode_faults_reach_every_checked_depth():
    """check_kernels reads each DECODE_FAULTS build at every depth of
    DECODE_DEPTHS, the speculative draft's 16 among them (its dense cache
    of DRAFT_ROWS rows). Every fault sits in decode_cluster, the body both
    cluster kernels run at each depth the depth switches instantiate, so
    each is planted in the D 16 kernels too."""
    from batch_shipyard_tpu_torch.ops import paged_attention
    text = (_build.CSRC / "decode_attention.cu").read_text()
    assert chip_smoke.DRAFT_DEPTH == 16 in chip_smoke.DECODE_DEPTHS
    assert chip_smoke.DRAFT_ROWS == chip_smoke.MAX_LEN + 4 + 1
    for depth in chip_smoke.DECODE_DEPTHS:
        assert depth in paged_attention.SUPPORTED_DEPTHS
        for switch in ("BS_PAGED", "BS_DENSE"):
            assert f"case {depth}: return {switch}({depth});" in text
    for kernel, _, _, cases in chip_smoke.DECODE_FAULTS:
        assert kernel == "decode_cluster"
        assert set(cases) <= {"paged", "paged_int8", "dense_int8"}
    for entry, dense in (("paged_decode_cluster_kernel", "false"),
                         ("dense_decode_cluster_kernel", "true")):
        start, end = chip_smoke.kernel_body(text, entry)
        assert f", D, {dense}>(" in text[start:end], entry


@pytest.mark.parametrize("index", chip_smoke.VREDUCE_FAULTS)
def test_each_k16_fault_build_plants_only_its_fault(index):
    """check_virtual reads K16's two faults (a wrong chunk read; two adds
    swapped) each from a build of its own, so that one cannot hide the
    other: plant_faults(name, only=i) changes that anchor and no other,
    and each sits in a helper that both K16 designs run."""
    faults = chip_smoke.FAULTS["ring_collectives"]
    text = (_build.CSRC / "ring_collectives.cu").read_text()
    planted = chip_smoke.plant_faults("ring_collectives", only=index)
    for i, (_, anchor, fault, _) in enumerate(faults):
        assert (anchor in planted) == (i != index)
        assert (fault in planted) == (i == index)
    kernel = faults[index][0]
    for design in ("virtual_reduce_scatter_kernel",
                   "virtual_reduce_scatter_bulk_kernel"):
        start, end = chip_smoke.kernel_body(text, design)
        assert f"{kernel}(" in text[start:end], (kernel, design)
    assert len(planted) - len(text) == len(faults[index][2]) - len(
        faults[index][1])


def test_one_by_one_faults_name_real_faults():
    """main() builds one library for each (source, index) of
    FAULTS_ONE_BY_ONE, and a shared one for the sources with others."""
    for name, indices in chip_smoke.FAULTS_ONE_BY_ONE.items():
        assert indices and len(set(indices)) == len(indices)
        assert all(0 <= i < len(chip_smoke.FAULTS[name]) for i in indices)
    assert chip_smoke.FAULTS_ONE_BY_ONE["decode_attention"] == tuple(
        range(len(chip_smoke.DECODE_FAULTS)))
    assert [chip_smoke.FAULTS["ring_collectives"][i][0]
            for i in chip_smoke.FAULTS_ONE_BY_ONE["ring_collectives"]] == \
        ["part_at", "chain_member"]
