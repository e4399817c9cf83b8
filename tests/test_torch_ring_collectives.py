"""The port's ring collectives (ops/ring_collectives.py) against the JAX
reference on the CPU.

- The schedule arithmetic equals the reference's.
- The plain versions of the one-device schedules (K15, K16) equal the
  reference's virtual kernels in interpret mode (rings 2 and 4; ring 8
  against the definition): all-gather exactly, reduce-scatter within
  1e-6 relative (the reference test's bound: the ring order of fp32 adds
  is the same, XLA's own adds may fuse).
- K15's tiling (``virtual_gather_tiles``) stores every output byte once,
  from the right shard, at rings 2, 4 and 8, in every copy unit and at
  ragged sizes.
- K16's tiling (``virtual_reduce_tiles``) writes every output element
  once, adding the members in the chain rs_chunk_index gives, at rings
  2, 3, 4 and 8, in every copy unit and at ragged sizes; a one-pass fold
  over those tiles equals the plain slot schedule bit for bit (fp32 and
  bf16) and the reference's kernel in interpret mode within 1e-6
  relative.
- The plain K12 (both shifts and its gradient), K13 and K14 over four
  gloo processes equal lax.ppermute / all_gather / psum_scatter over the
  four-device CPU mesh, computed in this process (exactly; K14 within
  1e-6 relative, another order of fp32 adds).

The CUDA kernels are held against these plain versions on the card by
chip_smoke.py.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from batch_shipyard_tpu.ops import ring_collectives as jrc
from batch_shipyard_tpu.parallel import mesh as jmesh
from batch_shipyard_tpu.utils.compat import shard_map
from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.ops import ring_collectives as rc
from batch_shipyard_tpu_torch.workloads import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS_TIMEOUT_S = 120


def _shards(ring, chunk, feat, seed=0):
    return np.random.RandomState(seed).randn(ring, chunk, feat).astype(
        np.float32)


def _identity(ring, rows, feat):
    return np.stack([np.full((rows, feat), i + 1.0, np.float32)
                     for i in range(ring)])


@pytest.mark.parametrize("ring", [2, 3, 4, 8])
def test_schedule_arithmetic_matches_reference(ring):
    for me in range(ring):
        for step in range(-1, ring):
            assert rc.ag_source_shard(me, step, ring) == \
                jrc.ag_source_shard(me, step, ring)
            assert rc.rs_chunk_index(me, step, ring) == \
                jrc.rs_chunk_index(me, step, ring)


# Rings 2 and 4 against the reference's kernels in interpret mode; ring
# 8 (~9 s a call in interpret mode) against the definition alone.
RINGS = [(2, False), (4, False), (8, False), (2, True), (4, True)]


@pytest.mark.parametrize("ring,identity", RINGS)
def test_virtual_all_gather_matches_reference(ring, identity):
    x = _identity(ring, 16, 128) if identity else _shards(ring, 16, 128)
    got = rc.ring_all_gather_virtual(torch.from_numpy(x)).numpy()
    if ring < 8:
        want = np.asarray(jrc.ring_all_gather_virtual(jnp.asarray(x),
                                                      interpret=True))
        np.testing.assert_array_equal(got, want)
    for i in range(ring):
        np.testing.assert_array_equal(got[i], x.reshape(-1, 128))


@pytest.mark.parametrize("ring,identity", RINGS)
def test_virtual_reduce_scatter_matches_reference(ring, identity):
    x = (_identity(ring, ring * 16, 128) if identity
         else _shards(ring, ring * 16, 128, seed=3))
    got = rc.ring_reduce_scatter_virtual(torch.from_numpy(x)).numpy()
    assert got.shape == (ring, 16, 128)
    if ring < 8:
        want = np.asarray(jrc.ring_reduce_scatter_virtual(
            jnp.asarray(x), interpret=True))
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 1e-6, rel
    total = x.sum(axis=0).reshape(ring, 16, 128)
    np.testing.assert_allclose(got, total, atol=1e-4, rtol=1e-5)
    if identity:  # small integers: every order of adds is exact
        np.testing.assert_array_equal(got, total)


def test_virtual_bf16_reduce_scatter_adds_in_ring_order():
    """bf16 rounds every partial: the plain K16 rounds where the ring adds
    (rank c+1's part first, then c+2, ...), which is what K16 does."""
    ring, chunk = 4, 8
    x = torch.from_numpy(_shards(ring, ring * chunk, 32, seed=5)).to(
        torch.bfloat16)
    got = rc.ring_reduce_scatter_virtual(x)
    for c in range(ring):
        parts = [x[(c + 1 + j) % ring, c * chunk:(c + 1) * chunk]
                 for j in range(ring)]
        acc = parts[0]
        for part in parts[1:]:
            acc = (acc.float() + part.float()).to(torch.bfloat16)
        assert torch.equal(got[c], acc), c


def test_virtual_schedules_reject_bad_rings():
    with pytest.raises(ValueError, match="2 members"):
        rc.ring_all_gather_virtual(torch.zeros(1, 16, 128))
    with pytest.raises(ValueError, match="2 members"):
        rc.ring_reduce_scatter_virtual(torch.zeros(1, 16, 128))
    with pytest.raises(ValueError, match="divisible"):
        rc.ring_reduce_scatter_virtual(torch.zeros(4, 18, 128))
    with pytest.raises(ValueError, match="CUDA"):
        rc.ring_all_gather_virtual_kernel(torch.zeros(2, 16, 128))
    with pytest.raises(ValueError, match="CUDA"):
        rc.ring_reduce_scatter_virtual_kernel(torch.zeros(2, 16, 128))


# Shard sizes: units 1, 2, 4 and 16, one tile or several with a ragged
# last one (VIRTUAL_TILE_UNITS 16-byte units is one tile).
TILED_BYTES = [7, 78, 156, 6656, 3 * 16 * rc.VIRTUAL_TILE_UNITS + 48,
               2 * rc.VIRTUAL_TILE_UNITS + 6]


@pytest.mark.parametrize("nbytes", TILED_BYTES)
@pytest.mark.parametrize("ring", [2, 4, 8])
def test_virtual_gather_tiles_cover_every_output_byte_once(ring, nbytes):
    """K15 tiles at VIRTUAL_TILE_UNITS copy units: in 16-byte units (the
    bulk design) a 32 KB stage, in narrower ones the register design's
    tile."""
    unit = rc.copy_unit(nbytes)
    tiles = {unit * rc.VIRTUAL_TILE_UNITS}
    shards = np.random.RandomState(ring).randint(
        0, 256, (ring, nbytes)).astype(np.uint8)
    run = shards.reshape(-1)
    for tile in tiles:
        out = np.zeros(ring * ring * nbytes, np.uint8)
        hits = np.zeros(out.shape, np.int64)
        spans = list(rc.virtual_gather_tiles(nbytes, ring, tile))
        assert len(spans) == -(-ring * nbytes // tile)
        for start, size, dsts in spans:
            assert start % unit == 0 and size % unit == 0 and 0 < size <= tile
            assert len(dsts) == ring
            for at in dsts:
                out[at:at + size] = run[start:start + size]
                hits[at:at + size] += 1
        assert (hits == 1).all(), tile
        want = np.asarray(jrc.ring_all_gather_virtual(
            jnp.asarray(shards[:, None, :]), interpret=True)) \
            if ring == 2 and nbytes < 200 else np.tile(run, (ring, 1))
        np.testing.assert_array_equal(out.reshape(ring, ring * nbytes),
                                      want.reshape(ring, ring * nbytes))


def test_virtual_tile_units_match_the_kernel_source():
    """VIRTUAL_TILE_UNITS is csrc vgather::kTileUnits (kThreads x kUnroll),
    and a bulk stage is that many 16-byte units; on the card chip_smoke
    also reads the library's bs_virtual_gather_tile_units."""
    source = (_build.CSRC / "ring_collectives.cu").read_text()
    vgather = source[source.index("namespace vgather {"):
                     source.index("}  // namespace vgather")]

    def constant(name, text=vgather):
        found = re.findall(rf"constexpr \w+(?: \w+)? {name} = (.+?);",
                           text)
        assert len(found) == 1, (name, found)
        return found[0]
    threads = int(constant("kThreads", source))
    unroll = int(constant("kUnroll"))
    assert threads * unroll == rc.VIRTUAL_TILE_UNITS
    assert constant("kTileUnits") == \
        "static_cast<long long>(kThreads) * kUnroll"
    assert constant("kStageBytes") == \
        "static_cast<int>(kTileUnits * 16)"
    assert "return vgather::kTileUnits;" in source


# (dtype, elements in a member's chunk): every copy unit of each dtype
# (fp32 16, 8, 4; bf16 16, 8, 4, 2), one tile a row or several with a
# ragged last one (the bulk design's tile at ring 2 is 2048 16-byte units,
# the register design's VIRTUAL_REDUCE_TILE_UNITS).
REDUCE_SIZES = [(torch.float32, 39), (torch.float32, 38),
                (torch.float32, 2048), (torch.float32, 2053),
                (torch.float32, 3 * 8192 + 12),
                (torch.bfloat16, 39), (torch.bfloat16, 38),
                (torch.bfloat16, 52), (torch.bfloat16, 3079),
                (torch.bfloat16, 16384 + 40)]


def _reduce_tile(dtype, elems, ring):
    """The copy unit (bytes) K16 takes for a chunk of ``elems`` (aligned
    addresses) at ``ring`` members, and its tile in elements."""
    size = torch.empty((), dtype=dtype).element_size()
    unit = rc.copy_unit(elems * size)
    return unit, rc.virtual_reduce_tile_units(ring, unit) * unit // size


def _ring_chain(row, ring):
    """The members whose parts of chunk ``row`` the slot schedule adds, in
    its order: at step s (-1 seeds) the one member m whose
    rs_chunk_index(m, s) is ``row``."""
    chain = []
    for step in range(-1, ring - 1):
        (member,) = [m for m in range(ring)
                     if rc.rs_chunk_index(m, step, ring) == row]
        chain.append(member)
    return tuple(chain)


@pytest.mark.parametrize("dtype,elems", REDUCE_SIZES)
@pytest.mark.parametrize("ring", [2, 3, 4, 8])
def test_virtual_reduce_tiles_cover_every_output_element_once(ring, dtype,
                                                              elems):
    unit, tile = _reduce_tile(dtype, elems, ring)
    size = torch.empty((), dtype=dtype).element_size()
    hits = np.zeros((ring, elems), np.int64)
    spans = list(rc.virtual_reduce_tiles(elems, ring, tile))
    assert len(spans) == ring * -(-elems // tile)
    for row, start, length, members in spans:
        assert start % tile == 0 and 0 < length <= tile
        assert start * size % unit == 0 and length * size % unit == 0
        assert members == _ring_chain(row, ring)
        hits[row, start:start + length] += 1
    assert (hits == 1).all()


def _one_pass_fold(x_rows: torch.Tensor) -> torch.Tensor:
    """K16's arithmetic in plain PyTorch: over virtual_reduce_tiles' tiles,
    each tile's parts read once per member and added in the tile's member
    order, T(float + float) at each add."""
    ring = x_rows.shape[0]
    chunk = x_rows.shape[1] // ring
    flat = x_rows.reshape(ring, ring, -1)  # [member, chunk, elements]
    elems = flat.shape[2]
    _, tile = _reduce_tile(x_rows.dtype, elems, ring)
    out = torch.empty((ring, elems), dtype=x_rows.dtype)
    for row, start, length, members in rc.virtual_reduce_tiles(elems, ring,
                                                               tile):
        acc = flat[members[0], row, start:start + length]
        for m in members[1:]:
            acc = (acc.float() + flat[m, row, start:start + length].float()
                   ).to(x_rows.dtype)
        out[row, start:start + length] = acc
    return out.reshape((ring, chunk) + x_rows.shape[2:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ring", [2, 3, 4, 8])
def test_one_pass_fold_equals_the_slot_schedule_bit_for_bit(ring, dtype):
    """Several 16-byte tiles a row, the last ragged, and a narrow unit:
    the fold rounds where the slot schedule rounds, so the bits agree."""
    for chunk, feat, seed in ((4, 4100, ring), (13, 3, ring + 1)):
        x = torch.from_numpy(_shards(ring, ring * chunk, feat,
                                     seed=seed)).to(dtype)
        got = _one_pass_fold(x)
        assert torch.equal(got, rc.ring_reduce_scatter_virtual_reference(x))


@pytest.mark.parametrize("ring", [2, 4])
def test_one_pass_fold_matches_reference_kernel(ring):
    x = _shards(ring, ring * 16, 128, seed=11)
    got = _one_pass_fold(torch.from_numpy(x)).numpy()
    want = np.asarray(jrc.ring_reduce_scatter_virtual(jnp.asarray(x),
                                                      interpret=True))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 1e-6, rel


def test_virtual_reduce_tile_units_match_the_kernel_source():
    """VIRTUAL_REDUCE_TILE_UNITS is csrc vreduce::kTileUnits (kBlock x
    kUnroll), VIRTUAL_REDUCE_STAGE_BYTES its kStageBytes, and
    virtual_reduce_tile_units its tile_units(); on the card chip_smoke
    also reads the library's bs_virtual_reduce_tile_units."""
    source = (_build.CSRC / "ring_collectives.cu").read_text()
    vreduce = source[source.index("namespace vreduce {"):
                     source.index("}  // namespace vreduce")]

    def constant(name):
        found = re.findall(rf"constexpr \w+(?: \w+)? {name} = (.+?);",
                           vreduce)
        assert len(found) == 1, (name, found)
        return found[0]
    assert int(constant("kBlock")) * int(constant("kUnroll")) == \
        rc.VIRTUAL_REDUCE_TILE_UNITS
    assert constant("kTileUnits") == \
        "static_cast<long long>(kBlock) * kUnroll"
    assert int(constant("kStageBytes")) == rc.VIRTUAL_REDUCE_STAGE_BYTES
    assert "return unit == 16 && ring <= kStageBytes / 16;" in vreduce
    assert ("return bulk(ring, unit) ? kStageBytes / (16 * ring) : "
            "kTileUnits;") in vreduce
    assert "return vreduce::tile_units(ring, unit);" in source
    for ring in (2, 3, 4, 8, 4096, 4097):
        assert rc.virtual_reduce_tile_units(ring, 16) == (
            65536 // (16 * ring) if ring <= 4096 else 1024)
        for unit in (8, 4, 2):
            assert rc.virtual_reduce_tile_units(ring, unit) == 1024


def test_copy_unit_and_slot_sizes():
    assert rc.copy_unit(4096, 256, 2 ** 20) == 16
    assert rc.copy_unit(4096, 8) == 8
    assert rc.copy_unit(6, 4096) == 2
    assert rc.copy_unit(7) == 1
    assert rc.permute_slot_bytes(1000) == 1024 + 1000


# A rank of the four-process check: the plain K12 (+1 with its gradient,
# -1), K13 and K14 on this rank's inputs; outputs saved for the parent.
WORKER = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from batch_shipyard_tpu_torch.ops import ring_collectives as rc
from batch_shipyard_tpu_torch.parallel import mesh
from batch_shipyard_tpu_torch.workloads import distributed
distributed.setup("cpu")
group = mesh.RingGroup()
r = group.rank
data = np.load(os.path.join(sys.argv[1], "inputs.npz"))
k = torch.from_numpy(data["k"][r]).requires_grad_()
v = torch.from_numpy(data["v"][r]).requires_grad_()
kp, vp = rc.ring_permute_pair(k, v, group)
((kp * torch.from_numpy(data["gk"][r])).sum() +
 (vp * torch.from_numpy(data["gv"][r])).sum()).backward()
km, vm = rc.ring_permute(k.detach(), v.detach(), group, shift=-1)
ag = rc.ring_all_gather(torch.from_numpy(data["chunks"][r]), group)
rs = rc.ring_reduce_scatter(torch.from_numpy(data["rows"][r]), group)
np.savez(os.path.join(sys.argv[1], f"rank{r}.npz"), kp=kp.detach().numpy(),
         vp=vp.detach().numpy(), km=km.numpy(), vm=vm.numpy(),
         gk=k.grad.numpy(), gv=v.grad.numpy(), ag=ag.numpy(), rs=rs.numpy(),
         plain=np.array([rc.plain_calls[key] for key in
                         ("ring_permute", "ring_all_gather",
                          "ring_reduce_scatter")]),
         launches=np.array(sum(rc.launches.values())))
"""


def run_ranks(script: str, args, nprocs: int = 4) -> None:
    """Run ``script`` as ``nprocs`` gloo ranks (one torch thread each),
    killing stragglers after RANKS_TIMEOUT_S; fail with their stderr."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    runs = distributed.launch_local(
        [sys.executable, "-c", script, *map(str, args)], nprocs,
        RANKS_TIMEOUT_S, env=env, cwd=REPO)
    bad = [r for r in runs if r["returncode"] != 0 or r["timed_out"]]
    assert not bad, [(r["rank"], r["returncode"], r["stderr"][-2000:])
                     for r in bad]


def _mesh4():
    return jmesh.make_mesh(jmesh.auto_axis_sizes(4, sp=4),
                           devices=jax.devices()[:4])


def _lax(fn, x, in_spec=P("sp"), out_spec=P("sp")):
    return np.asarray(shard_map(fn, mesh=_mesh4(), in_specs=in_spec,
                                out_specs=out_spec, check_vma=False)(x))


def test_four_ranks_match_lax_collectives(tmp_path):
    ring = 4
    rng = np.random.RandomState(7)
    shape = (2, 8, 3, 16)
    inputs = {name: rng.randn(ring, *shape).astype(np.float32)
              for name in ("k", "v", "gk", "gv")}
    inputs["chunks"] = rng.randn(ring, 6, 5).astype(np.float32)
    inputs["rows"] = rng.randn(ring, ring * 6, 5).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **inputs)
    run_ranks(WORKER, [tmp_path])
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(ring)]

    def stacked(name):
        return np.concatenate([g[name] for g in got])

    def flat(name):
        return jnp.asarray(inputs[name].reshape(ring * shape[0], *shape[1:]))
    right = [(i, (i + 1) % ring) for i in range(ring)]
    left = [(i, (i - 1) % ring) for i in range(ring)]
    for name in ("k", "v"):
        want = _lax(lambda s: jax.lax.ppermute(s, "sp", right), flat(name))
        np.testing.assert_array_equal(stacked(name + "p"), want)
        want = _lax(lambda s: jax.lax.ppermute(s, "sp", left), flat(name))
        np.testing.assert_array_equal(stacked(name + "m"), want)
        # The reference's gradient of sum(ppermute(x) * g) in x.
        grad = jax.grad(lambda x, g: jnp.sum(shard_map(
            lambda s: jax.lax.ppermute(s, "sp", right), mesh=_mesh4(),
            in_specs=P("sp"), out_specs=P("sp"), check_vma=False)(x) * g))(
                flat(name), flat("g" + name))
        np.testing.assert_array_equal(stacked("g" + name), np.asarray(grad))
    chunks = jnp.asarray(inputs["chunks"].reshape(ring * 6, 5))
    want = _lax(lambda s: jax.lax.all_gather(s, "sp", tiled=True), chunks,
                out_spec=P(None))
    for g in got:
        np.testing.assert_array_equal(g["ag"], want)
    want = _lax(lambda s: jax.lax.psum_scatter(s[0], "sp", tiled=True),
                jnp.asarray(inputs["rows"]), in_spec=P("sp", None))
    rs = stacked("rs")
    np.testing.assert_allclose(rs, want, atol=1e-5, rtol=1e-5)
    assert np.linalg.norm(rs - want) / np.linalg.norm(want) < 1e-6
    for g in got:
        # Plain versions ran (K12: forward, backward, the -1 call); no
        # kernel launched on CPU tensors.
        assert g["plain"].tolist() == [3, 1, 1]
        assert int(g["launches"]) == 0


# A rank whose ring group's error word reads "timed out" (what a ring
# kernel writes when a wait outlives the group's timeout), with a stand-in
# for the library's flag free: RingGroup.close must raise after freeing,
# and the train workload must raise when the word is set in its last step.
TIMEOUT_WORKER = r"""
import ctypes
import torch
torch.set_num_threads(1)
from batch_shipyard_tpu_torch.parallel import mesh
from batch_shipyard_tpu_torch.parallel import train as train_mod
from batch_shipyard_tpu_torch.workloads import distributed
from batch_shipyard_tpu_torch.workloads import train_transformer as wl
distributed.setup("cpu")


class Library:
    freed = 0

    def bs_ring_flag_free(self, flag):
        Library.freed += 1


def group_with_word(value):
    group = mesh.RingGroup(library=Library())
    group.error = (ctypes.c_int * 1)(value)
    return group


group_with_word(0).close()
group = group_with_word(1)
try:
    group.close()
    raise AssertionError("close() passed over a timed-out ring kernel")
except RuntimeError as err:
    assert "waited longer" in str(err), err
assert Library.freed == 2 and group.error is None


class Harness:
    calls = 0

    def step(self, batch):
        Harness.calls += 1
        if Harness.calls == 3:  # the last of 1 warm-up and 2 timed steps
            group.error[0] = 1
        return {"loss": torch.tensor(1.0)}


group = group_with_word(0)
mesh.RankMesh.build = (
    lambda device, **axes: mesh.RankMesh.of_sp_group(group))
train_mod.build_transformer_train = lambda *args, **kwargs: Harness()
try:
    wl.main(["--device", "cpu", "--sp", "2", "--warmup", "1", "--steps",
             "2", "--d-model", "8", "--n-heads", "2", "--n-layers", "1",
             "--d-ff", "16", "--vocab", "16", "--seq-len", "8", "--batch",
             "1"])
    raise AssertionError("main passed over a timeout in its last step")
except RuntimeError as err:
    assert "waited longer" in str(err), err
assert Harness.calls == 3
"""


def test_ring_timeout_raises_at_close_and_after_the_last_step():
    run_ranks(TIMEOUT_WORKER, [], nprocs=2)
