"""Distributed execution tests on the virtual 8-device CPU mesh.

The replacement for the reference's absent distribution layer (SURVEY.md §2
note): residue channels (`rns`) and poly batches (`batch`) are
zero-communication mesh axes mirroring the independent `cm` loops (reference
core.hpp:597,610); the degree axis (`deg`) is the four-step NTT with an
all-to-all transpose (parallel/ntt_dist.py).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import nfllib_tpu as nfl
from nfllib_tpu.ops import ntt as ntt_jnp
from nfllib_tpu.parallel import ntt_dist
from nfllib_tpu.utils import bitrev_indices

from conftest import make_ring, rand_residues


def _mesh(shape, names):
    devs = np.array(jax.devices("cpu")[: int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, axis_names=names)


# ---------------------------------------------------------------------------
# four-step math vs the Harvey path (single device)
# ---------------------------------------------------------------------------

def test_degenerate_four_step_split_raises():
    """n1/n2 < 2 (or factors that don't multiply to the degree) must raise
    a clear ValueError, not an obscure np.concatenate crash (round-5
    library review)."""
    ring = make_ring(16, 60, "u32")
    for n1, n2 in ((1, 16), (16, 1), (4, 8)):
        with pytest.raises(ValueError, match="four-step factors"):
            ntt_dist.get_four_step_context(ring, n1, n2)


@pytest.mark.parametrize("degree,agg,limb,n1", [
    (64, 60, "u32", 8),
    (256, 60, "u32", 16),
    (256, 14, "u16", 16),
    (64, 124, "u64", 8),
])
def test_four_step_matches_harvey(degree, agg, limb, n1, rng):
    ring = make_ring(degree, agg, limb)
    x = rand_residues(ring, rng)
    n2 = degree // n1
    four = np.asarray(ntt_dist.four_step_reference(x, ring, n1))
    harvey = np.asarray(ntt_jnp.ntt_pow_phi(x, ring.context()))
    # harvey[j] = E[bitrev_n(j)]; four[k1,k2] = E[k1 + n1*k2]
    rev = bitrev_indices(degree)
    E = four.reshape(ring.nmoduli, n1, n2).transpose(0, 2, 1).reshape(
        ring.nmoduli, degree)  # E[k] with k = k1 + n1*k2
    np.testing.assert_array_equal(harvey, E[:, rev])


@pytest.mark.parametrize("degree,agg,limb,n1", [
    (64, 60, "u32", 8),
    (256, 60, "u32", 16),
])
def test_four_step_roundtrip(degree, agg, limb, n1, rng):
    ring = make_ring(degree, agg, limb)
    x = rand_residues(ring, rng)
    y = ntt_dist.four_step_reference(x, ring, n1)
    back = np.asarray(ntt_dist.four_step_reference_inverse(y, ring, n1))
    np.testing.assert_array_equal(back, x)


# ---------------------------------------------------------------------------
# distributed four-step over the deg axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_distributed_ntt_matches_single_device(ndev, rng):
    ring = make_ring(256, 60, "u32")
    mesh = _mesh((ndev,), ("deg",))
    x = rand_residues(ring, rng)
    xd = jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, P(None, "deg")))
    out = np.asarray(ntt_dist.distributed_ntt_pow_phi(xd, ring, mesh))
    want = np.asarray(ntt_dist.four_step_reference(x, ring, 16))
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("ndev", [2, 8])
def test_distributed_roundtrip(ndev, rng):
    ring = make_ring(256, 60, "u32")
    mesh = _mesh((ndev,), ("deg",))
    x = rand_residues(ring, rng)
    xd = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "deg")))
    y = ntt_dist.distributed_ntt_pow_phi(xd, ring, mesh)
    back = np.asarray(ntt_dist.distributed_invntt_pow_invphi(y, ring, mesh))
    np.testing.assert_array_equal(back, x)


def test_distributed_pointwise_pipeline(rng):
    """NTT-domain pointwise product in the four-step layout: the full
    negacyclic product pipeline never needs a global reorder."""
    ring = make_ring(256, 60, "u32")
    ctx = ring.context()
    mesh = _mesh((4,), ("deg",))
    a = rand_residues(ring, rng)
    b = rand_residues(ring, rng)
    sh = NamedSharding(mesh, P(None, "deg"))
    ad = jax.device_put(jnp.asarray(a), sh)
    bd = jax.device_put(jnp.asarray(b), sh)
    fa = ntt_dist.distributed_ntt_pow_phi(ad, ring, mesh)
    fb = ntt_dist.distributed_ntt_pow_phi(bd, ring, mesh)
    from nfllib_tpu.ops import modops
    prod = modops.mulmod(fa, fb, jnp.asarray(ctx.p_col)[..., None],
                         jnp.asarray(ctx.pn_col)[..., None])
    got = np.asarray(
        ntt_dist.distributed_invntt_pow_invphi(prod, ring, mesh))
    from nfllib_tpu import oracle
    want = oracle.negacyclic_mul_schoolbook(a, b, ring)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# zero-communication rns/batch axes (pjit auto-sharding)
# ---------------------------------------------------------------------------

def test_rns_batch_sharded_ntt(rng):
    ring = make_ring(512, 120, "u32")  # 4 channels
    ctx = ring.context()
    mesh = _mesh((2, 4), ("batch", "rns"))
    x = rand_residues(ring, rng, batch=(4,))
    sh = NamedSharding(mesh, P("batch", "rns", None))
    xd = jax.device_put(jnp.asarray(x), sh)
    fn = jax.jit(lambda v: ntt_jnp.ntt_pow_phi(v, ctx),
                 in_shardings=sh, out_shardings=sh)
    with mesh:
        out = np.asarray(fn(xd))
    want = np.asarray(ntt_jnp.ntt_pow_phi(jnp.asarray(x), ctx))
    np.testing.assert_array_equal(out, want)


def test_mesh_api_shard_poly(rng):
    """parallel.api conveniences: mesh factoring, poly sharding placement,
    and a zero-comm batch+rns sharded op pipeline."""
    from nfllib_tpu.parallel import api
    import nfllib_tpu as nfl

    mesh = api.make_mesh(devices=jax.devices("cpu")[:8])
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "batch": 2, "rns": 2, "deg": 2}
    ring = make_ring(256, 120, "u32")     # 4 channels
    x = rand_residues(ring, rng, batch=(4,))
    p = nfl.Poly(jnp.asarray(x), ring)
    ps = api.shard_poly(p, mesh)
    assert ps == p
    q = (ps + ps).ntt_pow_phi()
    want = (p + p).ntt_pow_phi()
    assert q == want


def test_comm_volume_one_all_to_all_and_balanced_shards(rng):
    """The distributed transform's ONLY communication is one all-to-all
    (asserted on the compiled HLO), and per-device output shards are
    balanced (SURVEY.md §5 comm-backend / work-balance contract)."""
    ring = make_ring(1024, 60, "u32")
    mesh = _mesh((4,), ("deg",))
    x = jnp.asarray(rand_residues(ring, rng))
    with mesh:
        fwd = lambda v: ntt_dist.distributed_ntt_pow_phi(v, ring, mesh)
        hlo = jax.jit(fwd).lower(x).compile().as_text()
        n_a2a = hlo.count(" all-to-all(") + hlo.count(" all-to-all-start(")
        assert n_a2a == 1, f"expected exactly one all-to-all, got {n_a2a}"
        for coll in ("all-reduce(", "all-gather(", "collective-permute("):
            assert coll not in hlo, f"unexpected collective {coll}"
        y = fwd(x)
        shapes = {s.data.shape for s in y.addressable_shards}
        assert len(shapes) == 1, f"unbalanced shards: {sorted(shapes)}"
        # inverse likewise
        inv = lambda v: ntt_dist.distributed_invntt_pow_invphi(v, ring, mesh)
        hlo_i = jax.jit(inv).lower(y).compile().as_text()
        n_a2a_i = (hlo_i.count(" all-to-all(")
                   + hlo_i.count(" all-to-all-start("))
        assert n_a2a_i == 1
        back = inv(y)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_dist_tables_sharded_by_construction(rng):
    """The [m, n1, n2] twiddle tables are device_put with the mesh sharding
    at build time: each device holds 1/D of the table (no replicate+gather
    in the compiled program)."""
    ring = make_ring(1024, 60, "u32")
    mesh = _mesh((4,), ("deg",))
    x = jnp.asarray(rand_residues(ring, rng))
    xd = jax.device_put(x, NamedSharding(mesh, P(None, "deg")))
    _ = ntt_dist.distributed_ntt_pow_phi(xd, ring, mesh)
    # the build places the twiddle tables with the column sharding: each
    # device's shard is 1/D of the table
    n1, n2 = 32, 32
    fctx = ntt_dist.get_four_step_context(ring, n1, n2)
    col_sh = NamedSharding(mesh, P(None, None, "deg"))
    t = jax.device_put(np.asarray(fctx.twiddle), col_sh)
    shard_shapes = {s.data.shape for s in t.addressable_shards}
    assert shard_shapes == {(ring.nmoduli, n1, n2 // 4)}


def test_chunked_all_to_all_overlap(rng):
    """chunks > 1 splits twiddle+transpose into independent pieces (the
    comm/compute-overlap structure for multi-host scaling): bit-identical
    to the monolithic transform, with exactly `chunks` all-to-alls in the
    compiled program."""
    ring = make_ring(1024, 60, "u32")
    mesh = _mesh((4,), ("deg",))
    x = jnp.asarray(rand_residues(ring, rng))
    xd = jax.device_put(x, NamedSharding(mesh, P(None, "deg")))
    want = np.asarray(ntt_dist.distributed_ntt_pow_phi(xd, ring, mesh))
    with mesh:
        fwd = lambda v: ntt_dist.distributed_ntt_pow_phi(
            v, ring, mesh, chunks=4)
        hlo = jax.jit(fwd).lower(x).compile().as_text()
        n_a2a = hlo.count(" all-to-all(") + hlo.count(" all-to-all-start(")
        assert n_a2a == 4, f"expected 4 chunked all-to-alls, got {n_a2a}"
        got = np.asarray(fwd(xd))
    np.testing.assert_array_equal(got, want)
    # inverse mirrored: chunked transpose back, bit-identical roundtrip
    y = ntt_dist.distributed_ntt_pow_phi(xd, ring, mesh)
    with mesh:
        inv = lambda v: ntt_dist.distributed_invntt_pow_invphi(
            v, ring, mesh, chunks=2)
        hlo_i = jax.jit(inv).lower(y).compile().as_text()
        n_i = hlo_i.count(" all-to-all(") + hlo_i.count(" all-to-all-start(")
        assert n_i == 2, f"expected 2 chunked all-to-alls, got {n_i}"
        back = np.asarray(inv(y))
    np.testing.assert_array_equal(back, np.asarray(x))


@pytest.mark.slow
def test_multiprocess_distributed_ntt():
    """The EXECUTED multi-host entry: two OS processes join through
    parallel.api.init_distributed, build a cross-process mesh, and the
    distributed NTT is bit-exact vs single-process (tools/
    check_multiprocess.py; also run standalone to record MULTIPROC.json)."""
    import pathlib
    import subprocess
    import sys as _sys

    root = pathlib.Path(__file__).resolve().parent.parent
    r = subprocess.run([_sys.executable,
                        str(root / "tools" / "check_multiprocess.py")],
                       cwd=str(root), capture_output=True, text=True,
                       timeout=1200)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("degree,agg,limb,ndev", [
    (1024, 60, "u32", 4),
    (256, 124, "u64", 2),
    (4096, 124, "u64", 8),
])
def test_ppermute_transpose_variant(degree, agg, limb, ndev, rng):
    """transpose="ppermute" (d-1 point-to-point hops instead of one
    all-to-all) is bit-identical to the all-to-all path, forward and
    inverse."""
    ring = make_ring(degree, agg, limb)
    mesh = _mesh((ndev,), ("deg",))
    x = rand_residues(ring, rng)
    xd = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(None, "deg")))
    want = np.asarray(ntt_dist.distributed_ntt_pow_phi(xd, ring, mesh))
    y = ntt_dist.distributed_ntt_pow_phi(xd, ring, mesh,
                                         transpose="ppermute")
    np.testing.assert_array_equal(np.asarray(y), want)
    back = np.asarray(ntt_dist.distributed_invntt_pow_invphi(
        y, ring, mesh, transpose="ppermute"))
    np.testing.assert_array_equal(back, x)
    # the transform's transpose really became ppermutes: vs the a2a path
    # the program drops exactly the one transform all-to-all (any input
    # RESHARDING all-to-all at the jit boundary appears in both) and gains
    # the d-1 collective-permutes
    def a2a_count(hlo):
        return hlo.count(" all-to-all(") + hlo.count("all-to-all-start(")

    with mesh:
        base = jax.jit(lambda v: ntt_dist.distributed_ntt_pow_phi(
            v, ring, mesh)).lower(xd).compile().as_text()
        hlo = jax.jit(lambda v: ntt_dist.distributed_ntt_pow_phi(
            v, ring, mesh, transpose="ppermute")).lower(
                xd).compile().as_text()
    assert a2a_count(hlo) == a2a_count(base) - 1
    assert hlo.count("collective-permute") >= ndev - 1


@pytest.mark.parametrize("degree,agg,limb,ndev,B", [
    (1024, 60, "u32", 4, 3),
    (256, 124, "u64", 2, 4),
])
def test_batch_pipelined_matches_per_element(degree, agg, limb, ndev, B,
                                             rng):
    """distributed_ntt_pow_phi_pipelined (throughput mode: unrolled batch
    loop in ONE program, ppermute transposes a scheduler can overlap across
    batch elements) is bit-identical per element to the latency-mode path,
    and its compiled program carries one ppermute pipeline per batch
    element with no transform all-to-all."""
    ring = make_ring(degree, agg, limb)
    mesh = _mesh((ndev,), ("deg",))
    xs = np.stack([rand_residues(ring, rng) for _ in range(B)])
    xd = jax.device_put(jnp.asarray(xs),
                        NamedSharding(mesh, P(None, None, "deg")))
    got = np.asarray(ntt_dist.distributed_ntt_pow_phi_pipelined(
        xd, ring, mesh))
    for b in range(B):
        xb = jax.device_put(jnp.asarray(xs[b]),
                            NamedSharding(mesh, P(None, "deg")))
        want = np.asarray(ntt_dist.distributed_ntt_pow_phi(
            xb, ring, mesh, transpose="ppermute"))
        np.testing.assert_array_equal(got[b], want)
    with mesh:
        hlo = jax.jit(lambda v: ntt_dist.distributed_ntt_pow_phi_pipelined(
            v, ring, mesh)).lower(xd).compile().as_text()
    # no TRANSFORM all-to-all (at most one boundary-resharding a2a from the
    # input/output spec change, as in test_ppermute_transpose_variant)
    assert hlo.count(" all-to-all(") + hlo.count("all-to-all-start(") <= 1
    assert hlo.count("collective-permute") >= B * (ndev - 1)


@pytest.mark.parametrize("batch", [(), (2,)])
@pytest.mark.parametrize("transpose,chunks", [
    ("a2a", 1), ("ppermute", 1), ("a2a", 2)])
@pytest.mark.parametrize("degree,agg,limb", [
    (1024, 60, "u32"), (1024, 124, "u64")])
def test_distributed_matches_harvey_on_mesh(degree, agg, limb, transpose,
                                            chunks, batch, rng):
    """Deg-sharded four-step (jnp sub-DFTs) over 4 devices, every transpose
    variant, batched or not: == the single-device Harvey transform
    (harvey[j] = E[bitrev(j)]), and the inverse returns the input."""
    ring = make_ring(degree, agg, limb)
    mesh = _mesh((4,), ("deg",))
    x = rand_residues(ring, rng, batch=batch)
    spec = P(*([None] * (x.ndim - 1) + ["deg"]))
    xd = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
    y = ntt_dist.distributed_ntt_pow_phi(xd, ring, mesh, transpose=transpose,
                                         chunks=chunks)
    harvey = np.asarray(ntt_jnp.ntt_pow_phi(jnp.asarray(x), ring.context()))
    e = np.asarray(y).swapaxes(-1, -2).reshape(x.shape)
    np.testing.assert_array_equal(e[..., bitrev_indices(degree)], harvey)
    back = ntt_dist.distributed_invntt_pow_invphi(
        y, ring, mesh, transpose=transpose, chunks=chunks)
    np.testing.assert_array_equal(np.asarray(back), x)


@pytest.mark.parametrize("transpose,chunks,want", [
    ("auto", 1, ntt_dist._AUTO_TRANSPOSE), ("auto", 2, "a2a"),
    ("a2a", 1, "a2a"), ("ppermute", 1, "ppermute")])
def test_resolve_transpose(transpose, chunks, want):
    assert ntt_dist._resolve_transpose(transpose, chunks) == want


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm"])
def test_resolve_transpose_is_platform_free(platform, monkeypatch):
    """'auto' is the one measured choice whatever the process's backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert ntt_dist._resolve_transpose("auto") == ntt_dist._AUTO_TRANSPOSE
    assert ntt_dist._AUTO_TRANSPOSE in ("a2a", "ppermute")


def test_resolve_transpose_rejects_typos():
    with pytest.raises(ValueError):
        ntt_dist._resolve_transpose("ppermut")
    with pytest.raises(ValueError):
        ntt_dist.distributed_ntt_pow_phi_pipelined(
            jnp.zeros((1, 1, 64), jnp.uint32), make_ring(64, 30, "u32"),
            _mesh((2,), ("deg",)), transpose="all_to_all")
