"""The port's sharded stencil (``FusedStencilOp.apply_sharded``) against
the JAX package's under ``shard_map``.

The stencil cases are ``tests/test_distrib.py``'s five, with their
seeds (0, 5, 9, 13), shapes, mesh (2, 4) over (y, x) and tolerances, on
``hwc``, ``swc``, ``swc_stream`` and ``tc``: ``hwc`` with that file's own
φ, the CUDA strategies (whose kernels compile φ in) with the ``select``
φ of ``dxx``. The reference runs the same strategy as the port (its
Pallas kernels in interpret mode). Each case is also held against the
port's unsharded op. Where the reference raises (``swc_stream`` at depth
2 on a stream extent of 8 planes, or on a z-sharded block whose slabs
cannot hold the carried halo), the port must raise the same
``ValueError``.

The port's ranks are CPU processes over gloo (``launch.mesh.
run_on_mesh``, a ``FileStore``, no port number), where the CUDA
strategies take their plain versions; one spawn per mesh for the whole
module, the two at once: (2, 4) for the stencil cases, (2, 2) for the
MHD RHS (16³) and pair ops and for ``strategy="auto"``.
"""
import functools
import os
from concurrent.futures import ThreadPoolExecutor

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _torch_mesh_cases as cases  # noqa: E402
from repro.core.fusion import FusedStencilOp as JOp  # noqa: E402
from repro.core.stencil import derivative_operator_set as jdos  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro.physics import mhd as jm  # noqa: E402
from repro_torch.core.fusion import FusedStencilOp  # noqa: E402
from repro_torch.core.stencil import derivative_operator_set  # noqa: E402
from repro_torch.kernels.phi import select_phi  # noqa: E402
from repro_torch.launch.mesh import assemble_blocks, run_on_mesh  # noqa: E402
from repro_torch.physics import mhd as tm  # noqa: E402

STRATEGIES = ("hwc", "swc", "swc_stream", "tc")
MESH24 = ((2, 4), ("data", "model"))
MESH22 = ((2, 2), ("data", "model"))
YX = (None, "data", "model")
# tests/test_distrib.py's stencil cases: seed, shape, depth, its φ, aux.
STENCIL = {
    "single": dict(seed=0, shape=(2, 8, 16, 32), depth=1, phi="mix",
                   aux_shape=None, overlaps=(False,)),
    "overlap": dict(seed=5, shape=(2, 8, 16, 32), depth=1, phi="mix",
                    aux_shape=None, overlaps=(False, True)),
    "temporal": dict(seed=9, shape=(2, 8, 16, 32), depth=2, phi="pair",
                     aux_shape=None, overlaps=(False,)),
    "carry": dict(seed=13, shape=(2, 8, 32, 64), depth=2, phi="carry",
                  aux_shape=(1, 8, 32, 64), overlaps=(False, True)),
}
# swc_stream at depth 2 with z sharded: the shard holds the carried halo
# plus a chunk, the overlap's interior and z slabs do not.
ZSTREAM = dict(strategy="swc_stream", phi="select", n_out=2, depth=2,
               seed=17, shape=(2, 32, 8, 64), mesh_axes=("data", None,
                                                         "model"),
               aux_shape=None, overlaps=(False, True))
MHD = {
    "rhs_swc": dict(strategy="swc", form="rhs", shape=(16, 16, 16)),
    "rhs_tc": dict(strategy="tc", form="rhs", shape=(16, 16, 16)),
    "pair_swc": dict(strategy="swc", form="pair", shape=(28, 28, 8)),
    "pair_tc": dict(strategy="tc", form="pair", shape=(28, 28, 8)),
}
MHD_AXES = ("data", "model", None)
AUTO_SHAPE = (2, 16, 16, 32)


def _stencil_case(name, strategy):
    case = dict(STENCIL[name], strategy=strategy, mesh_axes=YX)
    if strategy != "hwc":
        case.update(phi="select", aux_shape=None)
    case["n_out"] = 3 if case["phi"] == "carry" else 2
    return case


def _shard_map(fn, mesh, in_specs, out_specs):
    if hasattr(jax, "shard_map"):
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    from jax.experimental.shard_map import shard_map

    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_rep=False)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every sharded case run once: the (2, 4) and (2, 2) meshes spawned
    at once; the ranks' output blocks saved under the directory."""
    out = tmp_path_factory.mktemp("sharded")
    stencil = {
        f"{name}_{s}": _stencil_case(name, s)
        for name in STENCIL for s in STRATEGIES
    }
    stencil["zstream"] = ZSTREAM
    mhd = {name: dict(c, mesh_axes=MHD_AXES, overlap=True)
           for name, c in MHD.items()}
    cache = tmp_path_factory.mktemp("tune-cache")
    with ThreadPoolExecutor(2) as pool:
        jobs = [
            pool.submit(run_on_mesh, cases.stencil_rank, *MESH24,
                        backend="gloo", device="cpu",
                        args=(stencil, str(out)), timeout=300),
            pool.submit(run_on_mesh, cases.mhd_and_auto_rank, *MESH22,
                        backend="gloo", device="cpu",
                        args=(mhd, AUTO_SHAPE, YX, str(cache), str(out)),
                        timeout=300),
        ]
        stencil_reports, mesh22 = (j.result() for j in jobs)
    return out, stencil_reports, mesh22


def _joined(out, name, what, mesh=MESH24, axes=YX):
    shape, names = mesh
    return assemble_blocks(
        cases.load_blocks(out, name, what, int(np.prod(shape))), shape,
        names, axes).double().numpy()


def _jphi(kind, strategy):
    if strategy != "hwc" or kind == "select":
        return lambda d: d["dxx"]
    if kind == "mix":
        return lambda d: jnp.stack([
            d["val"][0] + 0.1 * (d["dxx"] + d["dyy"] + d["dzz"])[0],
            d["dx"][1] * d["dy"][0] + d["dxy"][1],
        ])
    if kind == "pair":
        return lambda d: jnp.stack([
            d["val"][0] + 0.1 * (d["dxx"] + d["dyy"] + d["dzz"])[0],
            d["val"][1] + 0.05 * d["dx"][1] * d["dy"][0],
        ])

    def mk(c):
        def phi(d, a):
            f_new = d["val"] + c * d["dxx"] + 0.1 * a * d["dyy"][:1]
            w_new = 0.5 * a + c * d["val"][:1]
            return jnp.concatenate([f_new, w_new])
        return phi
    return (mk(0.3), mk(0.7))


def _inputs(case):
    rng = np.random.default_rng(case["seed"])
    f = rng.standard_normal(case["shape"]).astype(np.float32)
    aux = None
    if case["aux_shape"] is not None:
        aux = rng.standard_normal(case["aux_shape"]).astype(np.float32)
    return f, aux


def _reference(case, overlap, mesh=MESH24):
    """The JAX package's apply_sharded under shard_map on ``case``."""
    op = JOp(jdos(3, 6, spacing=0.3), _jphi(case["phi"], case["strategy"]),
             case["n_out"], strategy=case["strategy"],
             fuse_steps=case["depth"])
    f, aux = _inputs(case)
    spec = P(None, *case["mesh_axes"])
    jmesh = jmake_mesh(*mesh)
    if aux is None:
        fn = _shard_map(lambda fl: op.apply_sharded(
            fl, case["mesh_axes"], overlap=overlap), jmesh, spec, spec)
        return np.asarray(jax.jit(fn)(jnp.asarray(f)), np.float64)
    fn = _shard_map(lambda fl, al: op.apply_sharded(
        fl, case["mesh_axes"], al, overlap=overlap), jmesh, (spec, spec),
        spec)
    return np.asarray(jax.jit(fn)(jnp.asarray(f), jnp.asarray(aux)),
                      np.float64)


def _reference_overlapped(case):
    """The reference's overlapped path on ``hwc``; on the Pallas
    strategies, whose interpret mode compiles every slab's launch apart,
    its plain path, which its own test holds to the overlapped one at
    1e-6 (tests/test_distrib.py)."""
    return _reference(case, case["strategy"] == "hwc")


def _unsharded(case):
    """The port's unsharded op on the whole field (depth-2 "pair" cases
    as two single steps, as tests/test_distrib.py holds them)."""
    f, aux = _inputs(case)
    f, aux = torch.from_numpy(f), None if aux is None else torch.from_numpy(
        aux)
    ops = derivative_operator_set(3, 6, spacing=0.3)
    phi = cases.stencil_phi(case["phi"], case["strategy"])
    if case["phi"] == "pair" or (case["depth"] == 2 and aux is None):
        single = FusedStencilOp(ops, phi, case["n_out"],
                                strategy=case["strategy"], device="cpu")
        return single(single(f)).double().numpy()
    op = FusedStencilOp(ops, phi, case["n_out"], strategy=case["strategy"],
                        fuse_steps=case["depth"], device="cpu")
    return op(f, aux).double().numpy()


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _report(ranks, name):
    reports = ranks[1]
    assert len({str(r[name]) for r in reports}) == 1, "ranks disagree"
    return reports[0][name]


def _stream_raises_like_reference(ranks, name, case, overlap):
    status, message = _report(ranks, name)
    assert status == "ValueError"
    with pytest.raises(ValueError) as ref_err:
        _reference(case, overlap)
    for text in (message, str(ref_err.value)):
        assert "swc_stream" in text and "2·r·fuse_steps" in text
        assert "plus one chunk" in text


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_stencil_matches_single_device(ranks, strategy):
    """Seed 0: one sharded application equals the single-device op and
    the reference's apply_sharded (1e-5)."""
    case = _stencil_case("single", strategy)
    assert _report(ranks, f"single_{strategy}")[0] == "ok"
    got = _joined(ranks[0], f"single_{strategy}", "overlap0")
    _close(got, _reference(case, False), 1e-5, 1e-5)
    _close(got, _unsharded(case), 1e-5, 1e-5)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_overlap_matches_non_overlapped(ranks, strategy):
    """Seed 5: overlap=True is a scheduling change only (1e-6 of the
    plain path), equal to the single-device op and to the reference's
    overlapped path (1e-5); the decomposition engaged on every rank."""
    case = _stencil_case("overlap", strategy)
    status, paths = _report(ranks, f"overlap_{strategy}")
    assert status == "ok"
    assert paths == [{"plain": 1}, {"overlap": 1}]
    plain = _joined(ranks[0], f"overlap_{strategy}", "overlap0")
    overlapped = _joined(ranks[0], f"overlap_{strategy}", "overlap1")
    _close(overlapped, plain, 1e-6, 1e-6)
    _close(overlapped, _unsharded(case), 1e-5, 1e-5)
    _close(overlapped, _reference_overlapped(case), 1e-5, 1e-5)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_temporal_fusion_matches_single_device(ranks, strategy):
    """Seed 9, fuse_steps=2: one exchange of radius·2 planes buys two
    steps, equal to two single-device applications and the reference's
    (1e-4). swc_stream's stream extent of 8 planes cannot hold the
    carried 2·r·2 = 12 plus a chunk: both packages raise."""
    case = _stencil_case("temporal", strategy)
    if strategy == "swc_stream":
        _stream_raises_like_reference(ranks, "temporal_swc_stream", case,
                                      False)
        return
    assert _report(ranks, f"temporal_{strategy}")[0] == "ok"
    got = _joined(ranks[0], f"temporal_{strategy}", "overlap0")
    _close(got, _unsharded(case), 1e-4, 1e-4)
    _close(got, _reference(case, False), 1e-4, 1e-4)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_overlap_depth2_matches_non_overlapped(ranks, strategy):
    """Seed 13, fuse_steps=2 with overlap: the interior shrinks by
    radius·2, the slabs widen to it (on hwc the aux carry exchanged at
    radius·1); local extents (16, 16) exceed 2·r·2 = 12, so the
    decomposition engages (counted on every rank). Plain-path parity
    1e-4, the single-device op and the reference's 1e-4 / 1e-3."""
    case = _stencil_case("carry", strategy)
    if strategy == "swc_stream":
        _stream_raises_like_reference(ranks, "carry_swc_stream", case,
                                      False)
        return
    status, paths = _report(ranks, f"carry_{strategy}")
    assert status == "ok"
    assert paths == [{"plain": 1}, {"overlap": 1}]
    plain = _joined(ranks[0], f"carry_{strategy}", "overlap0")
    overlapped = _joined(ranks[0], f"carry_{strategy}", "overlap1")
    _close(overlapped, plain, 1e-4, 1e-4)
    _close(overlapped, _unsharded(case), 1e-4, 1e-3)
    _close(overlapped, _reference_overlapped(case), 1e-4, 1e-3)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_apply_sharded_rejects_mismatched_mesh_axes(strategy):
    """Too few or too many mesh_axes entries: the reference's ValueError
    up front, no mesh needed."""
    ops = derivative_operator_set(3, 2, spacing=0.3)
    phi = select_phi("val") if strategy != "hwc" else (lambda d: d["val"])
    op = FusedStencilOp(ops, phi, 2, strategy=strategy, device="cpu")
    f = torch.zeros((2, 8, 8, 8))
    with pytest.raises(ValueError, match="mesh_axes has 2 entries"):
        op.apply_sharded(f, ("data", "model"))
    with pytest.raises(ValueError, match="spatial dim"):
        op.apply_sharded(f, (None, None, "data", "model"))


def test_apply_sharded_rejects_non_periodic_modes():
    ops = derivative_operator_set(3, 2, spacing=0.3)
    op = FusedStencilOp(ops, select_phi("dxx"), 2, strategy="swc",
                        boundary_mode=("periodic", "dirichlet", "periodic"),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="periodic"):
        op.apply_sharded(torch.zeros((2, 8, 8, 8)), YX)
    jop = JOp(jdos(3, 2, spacing=0.3), lambda d: d["dxx"], 2,
              strategy="hwc",
              boundary_mode=("periodic", "dirichlet", "periodic"))
    with pytest.raises(NotImplementedError, match="periodic"):
        jop.apply_sharded(jnp.zeros((2, 8, 8, 8)), YX)


@pytest.mark.parametrize("overlap", (False, True))
def test_zsharded_stream_depth2_raises_like_reference(ranks, overlap):
    """swc_stream at depth 2 with z sharded over 2 ranks: the plain path
    runs (the 16-plane shard holds the carried 12 plus a chunk) and
    matches the reference; with overlap the interior and the z slabs
    cannot, and both packages raise the carried-halo ValueError."""
    status, detail = _report(ranks, "zstream")
    if overlap:
        assert status == "ValueError"
        with pytest.raises(ValueError) as ref_err:
            _reference(ZSTREAM, True)
        for text in (detail, str(ref_err.value)):
            assert "swc_stream" in text and "2·r·fuse_steps" in text
        return
    # the plain path ran before the overlap case raised
    got = _joined(ranks[0], "zstream", "overlap0",
                  axes=ZSTREAM["mesh_axes"])
    want = _reference(ZSTREAM, False)
    _close(got, want, 1e-4, 1e-4)


@functools.lru_cache(maxsize=None)
def _mhd_reference(form, shape):
    """The reference's apply_sharded on its XLA path (its plain
    exchange-then-apply: one compiled φ instead of five), once per form
    and shape for both strategies."""
    solver = jm.MHDSolver(shape, strategy="hwc")
    f = jnp.asarray(tm.MHDSolver(shape, device="cpu").init_fields(
        seed=3).numpy())
    spec = P(None, *MHD_AXES)
    jmesh = jmake_mesh(*MESH22)
    if form == "rhs":
        op = solver.rhs_op()
        fn = _shard_map(lambda fl: op.apply_sharded(fl, MHD_AXES),
                        jmesh, spec, spec)
        return np.asarray(jax.jit(fn)(f), np.float64)
    op = solver._fused_pair_op(1e-3)
    fn = _shard_map(lambda fl: op.apply_sharded(
        fl, MHD_AXES, jnp.zeros_like(fl)), jmesh, spec, spec)
    return np.asarray(jax.jit(fn)(f), np.float64)


@pytest.mark.parametrize("name", sorted(MHD))
def test_sharded_mhd_matches_reference(ranks, name):
    """The MHD RHS op (16³, depth 1) and the ``fuse_rk_pairs`` pair op
    (28x28x8, depth 2, the carry exchanged at radius·1) on (2, 2) over
    (z, y) with overlap, on swc and tc: the decomposition engaged, equal
    to the reference's apply_sharded (its XLA path) and to the port's
    unsharded op within 1e-5 of the largest |value|."""
    case = MHD[name]
    mhd_reports = [r[0] for r in ranks[2]]
    assert all(r[name] == {"overlap": 1} for r in mhd_reports)
    got = _joined(ranks[0], name, "out", MESH22, MHD_AXES)
    want = _mhd_reference(case["form"], case["shape"])
    solver = tm.MHDSolver(case["shape"], strategy=case["strategy"],
                          device="cpu")
    f = solver.init_fields(seed=3)
    if case["form"] == "rhs":
        own = solver.rhs_op()(f)
    else:
        own = solver._fused_pair_op(1e-3)(f, aux=torch.zeros_like(f))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - own.double().numpy()).max() <= 1e-5 * scale


def test_auto_resolves_once_on_rank_zero(ranks):
    """strategy="auto" on the mesh: rank 0 searches once, every other
    rank takes its broadcast plan without searching, all run the same
    (strategy, block, depth), a second call resolves by lookup, and the
    joined output equals the unsharded op on that plan."""
    autos = [r[1] for r in ranks[2]]
    assert [a["searches"] for a in autos] == [1, 0, 0, 0]
    assert len({a["plan"] for a in autos}) == 1
    assert all(a["equal_again"] for a in autos)
    strategy, block, depth = autos[0]["plan"]
    f = torch.from_numpy(np.random.default_rng(21).standard_normal(
        AUTO_SHAPE).astype(np.float32))
    op = FusedStencilOp(derivative_operator_set(3, 4, spacing=0.3),
                        select_phi("dxx"), 2, strategy=strategy,
                        block=block if strategy != "hwc" else None,
                        fuse_steps=depth, device="cpu")
    got = _joined(ranks[0], "auto", "out", MESH22, YX)
    _close(got, op(f).double().numpy(), 1e-5, 1e-5)
