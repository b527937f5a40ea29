"""The port's halo exchange (``repro_torch.core.halo``) against the JAX
package's (``repro.core.halo``).

The port runs on CPU ranks spawned by ``repro_torch.launch.mesh.
run_on_mesh`` over gloo (a ``FileStore`` in a temporary directory, no
port number), one spawn per mesh for the whole module, the three at
once: meshes (2, 4), (2,) and (1, 2), so axes of 1, 2 and 4 ranks, fields of ranks 1-3, radii
0-6, float32, float64 and bfloat16. The reference runs
``exchange_halos_nd`` / ``exchange_halo_1d`` under ``shard_map`` on the
same mesh with the same specs over 8 host devices. Data only moves, so
everything is held equal exactly: the joined padded blocks against the
reference's, and each rank's block against its slice of the field
padded whole with ``jnp.pad(mode="wrap")``.
"""
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
from repro.core import halo as jhalo  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro_torch.core import halo  # noqa: E402
from repro_torch.launch.mesh import assemble_blocks, run_on_mesh  # noqa: E402

MESHES = {
    "m24": ((2, 4), ("data", "model")),
    "m2": ((2,), ("data",)),
    "m12": ((1, 2), ("a", "b")),
}
# name: (mesh, mesh_axes, global shape, radii, dtype, axis of the 1-D
# exchange or None)
CASES = {
    "r3_f32": ("m24", (None, "data", "model"), (2, 8, 16, 32), (3, 3, 3),
               "float32", 2),
    "r3_f64_wide": ("m24", ("data", None, "model"), (1, 12, 8, 16),
                    (6, 2, 4), "float64", 0),
    "r2_bf16_r0": ("m24", ("model", "data"), (3, 16, 24), (4, 0),
                   "bfloat16", 0),
    "r1_f32": ("m24", ("model",), (2, 32), (5,), "float32", None),
    "r3_pair_f32": ("m2", ("data", None, None), (2, 8, 6, 10), (2, 1, 3),
                    "float32", 0),
    "r2_pair_f64": ("m2", (None, "data"), (1, 12, 8), (6, 4), "float64",
                    1),
    "r1_pair_bf16": ("m2", ("data",), (2, 16), (1,), "bfloat16", None),
    "r3_one_f32": ("m12", ("a", "b", None), (2, 6, 8, 10), (1, 2, 3),
                   "float32", 0),
    "r2_one_bf16": ("m12", ("b", "a"), (1, 8, 12), (3, 6), "bfloat16", 1),
}


def _shard_map(fn, mesh, in_specs, out_specs):
    if hasattr(jax, "shard_map"):
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    from jax.experimental.shard_map import shard_map

    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_rep=False)


@pytest.fixture(scope="module")
def exchanged(tmp_path_factory):
    """Every case run once, one spawn per mesh; the ranks' padded
    blocks saved under the returned directory."""
    out = tmp_path_factory.mktemp("halo")

    def spawn(mesh_name):
        shape, axes = MESHES[mesh_name]
        mine = {
            name: (c[1], c[2], c[3], c[4], c[5])
            for name, c in CASES.items() if c[0] == mesh_name
        }
        return run_on_mesh(
            cases.halo_rank, shape, axes, backend="gloo", device="cpu",
            args=(mine, str(out)), timeout=300,
        )

    with ThreadPoolExecutor(len(MESHES)) as pool:
        counts = dict(zip(MESHES, pool.map(spawn, MESHES)))
    return out, counts


def _jax_field(name):
    _, _, shape, _, dtype, _ = CASES[name]
    a = jnp.asarray(cases.field(shape, dtype, seed=len(name)))
    return a.astype(jnp.bfloat16) if dtype == "bfloat16" else a


def _as_f64(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float64))


@pytest.mark.parametrize("name", sorted(CASES))
def test_exchange_halos_nd_matches_reference(exchanged, name):
    out, _ = exchanged
    mesh_name, mesh_axes, shape, radii, dtype, _ = CASES[name]
    mshape, axes = MESHES[mesh_name]
    spec = P(None, *mesh_axes)
    want = jax.jit(_shard_map(
        lambda fl: jhalo.exchange_halos_nd(
            fl, radii, mesh_axes, spatial_axes=tuple(range(1, len(shape)))),
        jmake_mesh(mshape, axes), spec, spec,
    ))(_jax_field(name))
    got = assemble_blocks(
        cases.load_blocks(out, name, "nd", int(np.prod(mshape))),
        mshape, axes, mesh_axes)
    assert got.shape == want.shape
    assert np.array_equal(got.double().numpy(), _as_f64(want))


@pytest.mark.parametrize(
    "name", sorted(n for n, c in CASES.items() if c[5] is not None))
def test_exchange_halo_1d_matches_reference(exchanged, name):
    out, _ = exchanged
    mesh_name, mesh_axes, shape, radii, dtype, a = CASES[name]
    mshape, axes = MESHES[mesh_name]
    spec = P(None, *mesh_axes)
    want = jax.jit(_shard_map(
        lambda fl: jhalo.exchange_halo_1d(
            fl, radii[a], mesh_axes[a], axis=1 + a),
        jmake_mesh(mshape, axes), spec, spec,
    ))(_jax_field(name))
    got = assemble_blocks(
        cases.load_blocks(out, name, "1d", int(np.prod(mshape))),
        mshape, axes, mesh_axes)
    assert np.array_equal(got.double().numpy(), _as_f64(want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_padded_blocks_are_slices_of_the_wrapped_field(exchanged, name):
    """Each rank's padded block equals its window of the field padded
    whole (``jnp.pad(mode="wrap")``): the ring wrap is the periodic
    image, corners included."""
    out, _ = exchanged
    mesh_name, mesh_axes, shape, radii, dtype, _ = CASES[name]
    mshape, axes = MESHES[mesh_name]
    wrapped = _as_f64(jnp.pad(
        _jax_field(name), [(0, 0)] + [(r, r) for r in radii], mode="wrap"))
    blocks = cases.load_blocks(out, name, "nd", int(np.prod(mshape)))
    for rank, block in enumerate(blocks):
        coords = np.unravel_index(rank, mshape)
        window = [slice(None)]
        for a, (name_a, r) in enumerate(zip(mesh_axes, radii)):
            n = shape[1 + a]
            if name_a is None:
                window.append(slice(None))
                continue
            k = mshape[axes.index(name_a)]
            i = coords[axes.index(name_a)]
            window.append(slice(i * n // k, (i + 1) * n // k + 2 * r))
        assert np.array_equal(block.double().numpy(),
                              wrapped[tuple(window)]), rank


def test_exchange_counts_bytes_sent(exchanged):
    """The counters report what each rank sent: 2 messages of r planes
    per axis of more than one rank, nothing for a local wrap."""
    _, counts = exchanged
    for mesh_name, (mshape, axes) in MESHES.items():
        sent = 0
        exchanges = 0
        for name, (m, mesh_axes, shape, radii, dtype, a1) in CASES.items():
            if m != mesh_name:
                continue
            item = {"float32": 4, "float64": 8, "bfloat16": 2}[dtype]
            local = [shape[0]] + [
                n // (mshape[axes.index(nm)] if nm else 1)
                for n, nm in zip(shape[1:], mesh_axes)]
            padded = list(local)
            for ax, (nm, r) in enumerate(zip(mesh_axes, radii)):
                if nm is not None and r and mshape[axes.index(nm)] > 1:
                    slab = list(padded)
                    slab[1 + ax] = r
                    sent += 2 * int(np.prod(slab)) * item
                    exchanges += 1
                    if a1 == ax:  # the 1-D exchange of the same axis
                        one = list(local)
                        one[1 + ax] = r
                        sent += 2 * int(np.prod(one)) * item
                        exchanges += 1
                padded[1 + ax] += 2 * r
        for rank_counts in counts[mesh_name]:
            assert rank_counts.get("bytes", 0) == sent
            assert rank_counts.get("exchanges", 0) == exchanges
            assert rank_counts.get("messages", 0) == 2 * exchanges


@pytest.mark.parametrize("shape,radii,axes", [
    ((2, 8, 16, 32), (3, 3, 3), (1, 2, 3)),
    ((1, 12, 8), (0, 2), (1, 2)),
    ((3, 20), (4,), (1,)),
    ((2, 6, 8, 10), (1, 0, 2), (1, 2, 3)),
])
def test_interior_first_matches_reference(shape, radii, axes):
    f = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    view, edges = halo.interior_first(torch.from_numpy(f), radii, axes)
    jview, jedges = jhalo.interior_first(jnp.asarray(f), radii, axes)
    assert np.array_equal(view.numpy(), np.asarray(jview))
    assert [(a, (s.start, s.stop)) for a, s in edges] == [
        (a, (s.start, s.stop)) for a, s in jedges]


def test_exchange_rejects_mismatched_lengths():
    f = torch.zeros((2, 8, 8, 8))
    with pytest.raises(ValueError, match="one entry per spatial"):
        halo.exchange_halos_nd(f, (1, 1), (None, None, None),
                               spatial_axes=(1, 2, 3))
    with pytest.raises(ValueError, match="one entry per spatial"):
        jhalo.exchange_halos_nd(jnp.zeros((2, 8, 8, 8)), (1, 1),
                                (None, None, None), spatial_axes=(1, 2, 3))


def test_unsharded_axes_wrap_without_a_mesh():
    """With no named axis, the exchange is the local periodic wrap (no
    mesh, no process group)."""
    f = np.random.default_rng(7).standard_normal((2, 5, 6, 7))
    got = halo.exchange_halos_nd(torch.from_numpy(f), (2, 0, 3),
                                 (None, None, None), spatial_axes=(1, 2, 3))
    want = np.pad(f, [(0, 0), (2, 2), (0, 0), (3, 3)], mode="wrap")
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="DeviceMesh"):
        halo.exchange_halos_nd(torch.from_numpy(f), (1, 1, 1),
                               (None, "data", None), spatial_axes=(1, 2, 3))
