"""bf16 serving and the artifacts that run without the model code, on the
CPU, against the JAX package.

Mirrors ``tests/test_serve_dtype.py`` and ``tests/test_serving.py``.  The
port's bf16 path is the rollout kernels' bf16 instantiation (bf16 weights
and carries, float32 products and gates); here it runs their plain bf16
versions, which do the same casts.  JAX rounds at other places (its gate
math runs in bf16 too), so the two packages' bf16 samples are held to
``test_serve_dtype.py``'s bounds: elementwise 0.15 * (max |f32| + 1), the
per-series mean within 0.02 and the standard deviation within rtol 0.05 /
atol 0.02.  The float32 path is pinned bit for bit.  JAX's draws are
handed to the port as tensors (``k_e, k_r = split(key)``); the weights
are the port's, handed to JAX through ``convert`` (a JAX init costs
seconds here).  The win generate's bf16 loop is held to JAX's in
``tests/test_torch_port_win.py::test_generate_matches_jax``.
"""

import dataclasses
import subprocess
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_connexe_torch import convert
from vae_connexe_torch.models import CRVAE, ErrorVAE, WInCRVAE
from vae_connexe_torch.ops import cuda_rollout as cr
from vae_connexe_torch.ops import library  # noqa: F401  (the ops)
from vae_connexe_torch.ops.gru import gru_step_heads
from vae_connexe_torch.serving import (
    export_generator,
    export_win_generator,
    load_generator,
)
from vae_connexe_torch.train import generate_from_draws, generate_with_compensation
from vae_connexe_tpu.models import CRVAE as JCRVAE
from vae_connexe_tpu.models import ErrorVAE as JErrorVAE
from vae_connexe_tpu.train import generate_with_compensation as jax_generate
from torch_threads import one_torch_thread  # noqa: F401

P, H = 6, 32
BF = torch.bfloat16
H100 = (232448, 233472, 132, 2048, 8, 16)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close_in_distribution(got, want):
    """test_serve_dtype.py's bounds of a bf16 sample against another."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.max(np.abs(got - want)) < 0.15 * (np.abs(want).max() + 1.0)
    np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)),
                               atol=0.02)
    np.testing.assert_allclose(got.std(axis=(0, 1)), want.std(axis=(0, 1)),
                               rtol=0.05, atol=0.02)


def _bf16_not_f32(got, f32):
    """A bf16 entry point's output: float32 holding bf16 values only, and
    not the float32 path's output on the same draws (which holds values
    bf16 cannot represent, so the check tells the two apart)."""
    got, f32 = torch.as_tensor(got), torch.as_tensor(f32)
    assert got.dtype == f32.dtype == torch.float32
    torch.testing.assert_close(got, got.to(BF).float(), rtol=0, atol=0)
    assert not torch.equal(f32, f32.to(BF).float())
    assert not torch.equal(got, f32)


def _to_jax(jax_model, params):
    """The port's parameters as the JAX model's pytree."""
    tmpl = jax.eval_shape(jax_model.init, jax.random.key(0))
    return jax.tree.map(jnp.asarray, flax.serialization.from_state_dict(
        tmpl, convert.to_numpy(params)))


@pytest.fixture(scope="module")
def pair():
    """test_serve_dtype.py's pair's shapes (p=6, H=32), in both packages."""
    m, e = CRVAE(p=P, hidden=H), ErrorVAE(d=P, hidden=H)
    g = torch.Generator().manual_seed(0)
    tp, tep = m.init(g, "cpu"), e.init(g, "cpu")
    jm, je = JCRVAE(p=P, hidden=H), JErrorVAE(d=P, hidden=H)
    return (jm, je, _to_jax(jm, tp), _to_jax(je, tep)), (m, e, tp, tep)


def test_rollout_bf16_matches_jax(pair):
    """Same h0 draw: the port's bf16 rollout is float32 out and tracks JAX's
    bf16 rollout (and the port's own float32 one) in distribution."""
    (jm, _, jp, _), (m, _, tp, _) = pair
    key = jax.random.key(3)
    want = np.asarray(jm.rollout(jp, key, 64, dtype=jnp.bfloat16))
    h0 = _t(jax.random.normal(key, (64, H)))
    got = m.rollout(tp, None, 64, dtype=torch.bfloat16, h0=h0)
    assert got.shape == (64, m.rollout_len, P)
    _close_in_distribution(got, want)
    f32 = m.rollout(tp, None, 64, h0=h0)
    _close_in_distribution(got, f32)
    _bf16_not_f32(got, f32)
    # JAX's spelling of the dtype too.
    torch.testing.assert_close(m.rollout(tp, None, 64, dtype="bfloat16",
                                         h0=h0), got, rtol=0, atol=0)


def test_conditioned_rollout_bf16_matches_jax(pair):
    (jm, _, jp, _), (m, _, tp, _) = pair
    ctx = jax.random.normal(jax.random.key(5), (8, m.enc_len, P))
    key = jax.random.key(6)
    want = np.asarray(jm.conditioned_rollout(jp, ctx, key,
                                             dtype=jnp.bfloat16))
    eps = _t(jax.random.normal(key, (8, H)))
    got = m.conditioned_rollout(tp, _t(ctx), None, dtype=torch.bfloat16,
                                eps=eps)
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want)) < 0.15 * (np.abs(want).max()
                                                         + 1.0)
    np.testing.assert_allclose(got.numpy().std(), want.std(), rtol=0.05)
    _bf16_not_f32(got, m.conditioned_rollout(tp, _t(ctx), None, eps=eps))


def test_errvae_sample_bf16_contract(pair):
    (_, je, _, jep), (_, e, _, tep) = pair
    key = jax.random.key(4)
    want = np.asarray(je.sample(jep, key, 16, 20, dtype=jnp.bfloat16))
    h0 = _t(jax.random.normal(key, (16, H)))
    got = e.sample(tep, None, 16, 20, dtype=torch.bfloat16, h0=h0)
    assert got.dtype == torch.float32 and got.shape == (16, 21, e.d)
    np.testing.assert_array_equal(got[:, 0].numpy(), 0.0)
    assert np.max(np.abs(got.numpy() - want)) < 0.15 * (np.abs(want).max()
                                                         + 1.0)
    _bf16_not_f32(got, e.sample(tep, None, 16, 20, h0=h0))


def test_generate_with_compensation_bf16_matches_jax(pair):
    """JAX's bf16 compensated generation against the port's on the same two
    draws (error VAE's h0 first), and ``generate_with_compensation`` is
    ``generate_from_draws`` on the bf16 weights."""
    (jm, je, jp, jep), (m, e, tp, tep) = pair
    key = jax.random.key(8)
    want = np.asarray(jax_generate(jm, je, jp, jep, key, 64,
                                   dtype=jnp.bfloat16))
    k_e, k_r = jax.random.split(key)
    h0e, h0 = (_t(jax.random.normal(k, (64, H))) for k in (k_e, k_r))
    groups = [cr.cast_weights(g, BF)
              for g in (tp.heads, tp.readout, tep.dec, tep.out)]
    got = generate_from_draws(m, e, *groups, h0e, h0)
    _close_in_distribution(got, want)
    _bf16_not_f32(got, generate_from_draws(
        m, e, tp.heads, tp.readout, tep.dec, tep.out, h0e, h0))
    g = torch.Generator().manual_seed(2)
    again = generate_with_compensation(m, e, tp, tep, g, 64, dtype=BF)
    g = torch.Generator().manual_seed(2)
    draws = [torch.randn((64, H), generator=g) for _ in range(2)]
    torch.testing.assert_close(again, generate_from_draws(m, e, *groups,
                                                          *draws),
                               rtol=0, atol=0)
    _bf16_not_f32(again, generate_with_compensation(
        m, e, tp, tep, torch.Generator().manual_seed(2), 64))


def test_default_path_unchanged(pair):
    """dtype None, "float32" and torch.float32 are the one float32 program,
    and the plain K1 is still the per-step loop it was before bf16, bit
    for bit."""
    _, (m, e, tp, tep) = pair
    g = torch.Generator().manual_seed(7)
    h0 = torch.randn((8, H), generator=g)
    noise = torch.randn((8, m.rollout_len, P), generator=g)
    outs = [m.rollout(tp, None, 8, noise=noise, dtype=d, h0=h0)
            for d in (None, "float32", torch.float32)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
    h, x, steps = h0.expand(P, 8, H), torch.zeros((8, P)), []
    for t in range(m.rollout_len):
        h = gru_step_heads(tp.heads, x, h)
        out = (torch.einsum("pbh,poh->pbo", h, tp.readout.w)
               + tp.readout.b[:, None, :])
        x = out[..., 0].T + m.noise_scale * noise[:, t]
        steps.append(x)
    torch.testing.assert_close(outs[0], torch.stack(steps, dim=1), rtol=0,
                               atol=0)


def test_plain_bf16_rounds_carries(pair):
    """The plain bf16 versions (the kernels' yardstick) emit bf16 values as
    float32, and K1's equals its casts written out: bf16 x0, h0 and noise,
    float32 products and gates, each state and x rounded to bf16."""
    _, (m, e, tp, tep) = pair
    g = torch.Generator().manual_seed(9)
    heads, ro = (cr.cast_weights(w, BF) for w in (tp.heads, tp.readout))
    h0 = torch.randn((5, H), generator=g)
    x0 = torch.randn((5, P), generator=g)
    noise = torch.randn((5, 4, P), generator=g)
    got = cr.crvae_free_run_plain(heads, ro, x0, h0, noise, 0.1)
    rnd = lambda t: t.to(BF).float()                       # noqa: E731
    f32 = [cr.cast_weights(w, torch.float32) for w in (heads, ro)]
    h, x, want = rnd(h0).expand(P, 5, H), rnd(x0), []
    for t in range(4):
        h = rnd(gru_step_heads(f32[0], x, h))
        out = torch.einsum("pbh,poh->pbo", h, f32[1].w) + f32[1].b[:, None]
        x = rnd(out[..., 0].T + 0.1 * rnd(noise[:, t]))
        want.append(x)
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=0, atol=0)
    torch.testing.assert_close(got, rnd(got), rtol=0, atol=0)
    s = cr.errvae_sample_plain(cr.cast_weights(tep.dec, BF),
                               cr.cast_weights(tep.out, BF), h0, P, 3)
    assert s.dtype == torch.float32
    torch.testing.assert_close(s, rnd(s), rtol=0, atol=0)


def test_wrappers_take_one_storage_type(pair):
    _, (m, _, tp, _) = pair
    h0 = torch.zeros((2, H))
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        cr.crvae_free_run_fused(cr.cast_weights(tp.heads, BF), tp.readout,
                                torch.zeros((2, P)), h0,
                                torch.zeros((2, 3, P)), 0.1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cr.serve_dtype(torch.float16)


def test_route_counts_bf16_bytes():
    """bf16 weights halve a resident block's weight bytes: at
    lorenz96_scaled's d=40, H=128 K2 takes the resident route, while K1's
    40 heads need more blocks than a cluster holds and stay streamed on the
    float32 plan (the streamed block holds its weights in float32 in both
    types); at the serving width both stay resident on smaller blocks.  A
    bf16 resident block is the tensor-core body's (``mma_smem_bytes``):
    bf16 rows of [W_ih | W_hh], x and the state, each row stride 4 words
    past a multiple of 8, so that an ldmatrix phase meets no bank twice;
    tiles of a multiple of 16 rows and no k split."""
    f32 = cr.resident_smem_bytes(1, 4, 40, 128, 40, False)
    b16 = cr.resident_smem_bytes(1, 16, 40, 128, 40, False, elem=2)
    assert b16 < H100[0] < f32
    assert b16 == cr.mma_smem_bytes(1, 16, 40, 128, 40, False)
    kx, kh, hu = cr.mma_dims(40, 128)
    assert (kx, kh, hu) == (48, 128, 128)
    for n in (kx, kh, kx + kh):
        assert cr.mma_ld(n) // 2 % 8 == 4                # disjoint banks
    for batch in (3072, 1):
        assert cr.rollout_route("errvae", 1, batch, 40, 128, H100).route == \
            "streamed"
        plan = cr.rollout_route("errvae", 1, batch, 40, 128, H100, 2)
        assert plan.route == "resident" and plan.smem <= H100[0]
        assert (plan.split, plan.bt % cr.MMA_ROWS) == (0, 0)
        k1 = cr.rollout_route("crvae", 40, batch, 40, 128, H100)
        k1_16 = cr.rollout_route("crvae", 40, batch, 40, 128, H100, 2)
        assert k1.route == k1_16.route == "streamed"
        assert k1_16 == k1
        a = cr.rollout_route("crvae", 20, batch, 20, 64, H100)
        b = cr.rollout_route("crvae", 20, batch, 20, 64, H100, 2)
        assert (a.route, a.cluster) == ("resident", 7)
        assert b.route == "resident" and b.threads == cr.MMA_THREADS
        assert b.smem <= H100[0] and b.cluster <= H100[5]


# The bf16 resident plans (route, cluster, heads a block, tile, split,
# threads, shared memory) at an H100's limits, the shared memory written
# out region by region: weights 3 x Hu rows of mma_ld(Kx + Kh) bf16 a head,
# biases 4 x Hu floats a head, readout rows (K1: round4(H) floats a column;
# K2: round8(D) bf16 rows of mma_ld(Kh)) and their biases (16 bytes at
# least), two x buffers of mma_ld(Kx) bf16 a row, two state buffers of
# mma_ld(Kh) bf16 a row a head, K1's two noise buffers of a float a column
# and row.
@pytest.mark.parametrize("kind,heads,batch,d,hidden,want", [
    # Serving width, Kx 32, Kh 64, Hu 64.  At B=3072 4 heads a block on
    # 5-block clusters with 48-row tiles: 64 tiles over the 23 clusters the
    # card is taken to hold, 3 rounds of 4 items a warp.  At B=1 and 37 2
    # heads a block on 10 blocks (non-portable), the narrowest tile: one
    # round, and 16 items a block where 3 heads would take 24.
    ("crvae", 20, 3072, 20, 64, ("resident", 5, 4, 48, 0, 768,
                                 4 * 3 * 64 * 104 * 2 + 4 * 4 * 64 * 4
                                 + 4 * 64 * 4 + 16 + 2 * 48 * 40 * 2
                                 + 2 * 4 * 48 * 72 * 2 + 2 * 4 * 48 * 4)),
    ("crvae", 20, 37, 20, 64, ("resident", 10, 2, 16, 0, 768,
                               2 * 3 * 64 * 104 * 2 + 2 * 4 * 64 * 4
                               + 2 * 64 * 4 + 16 + 2 * 16 * 40 * 2
                               + 2 * 2 * 16 * 72 * 2 + 2 * 2 * 16 * 4)),
    ("crvae", 20, 1, 20, 64, ("resident", 10, 2, 16, 0, 768,
                              2 * 3 * 64 * 104 * 2 + 2 * 4 * 64 * 4
                              + 2 * 64 * 4 + 16 + 2 * 16 * 40 * 2
                              + 2 * 2 * 16 * 72 * 2 + 2 * 2 * 16 * 4)),
    # lorenz96_scaled's ErrorVAE: one head, d=40 outputs; Kx 48, Kh 128.
    ("errvae", 1, 3072, 40, 128, ("resident", 1, 1, 32, 0, 768,
                                  3 * 128 * 184 * 2 + 4 * 128 * 4
                                  + 40 * 136 * 2 + 160 + 2 * 32 * 56 * 2
                                  + 2 * 32 * 136 * 2)),
    ("errvae", 1, 37, 40, 128, ("resident", 1, 1, 16, 0, 768,
                                3 * 128 * 184 * 2 + 4 * 128 * 4
                                + 40 * 136 * 2 + 160 + 2 * 16 * 56 * 2
                                + 2 * 16 * 136 * 2)),
    ("errvae", 1, 1, 40, 128, ("resident", 1, 1, 16, 0, 768,
                               3 * 128 * 184 * 2 + 4 * 128 * 4
                               + 40 * 136 * 2 + 160 + 2 * 16 * 56 * 2
                               + 2 * 16 * 136 * 2)),
    # An odd width: H=7 pads to 8 units and to k 16, D=6 to k 16.
    ("crvae", 6, 37, 6, 7, ("resident", 6, 1, 16, 0, 768,
                            3 * 8 * 40 * 2 + 4 * 8 * 4 + 32 + 16
                            + 2 * 16 * 24 * 2 + 2 * 16 * 24 * 2
                            + 2 * 16 * 4)),
    ("errvae", 1, 37, 6, 7, ("resident", 1, 1, 16, 0, 768,
                             3 * 8 * 40 * 2 + 4 * 8 * 4 + 8 * 24 * 2 + 32
                             + 2 * 16 * 24 * 2 + 2 * 16 * 24 * 2)),
    # henon_author's p=2: a 2-block cluster, one head a block.
    ("crvae", 2, 256, 2, 64, ("resident", 2, 1, 16, 0, 768,
                              3 * 64 * 88 * 2 + 4 * 64 * 4 + 64 * 4 + 16
                              + 2 * 16 * 24 * 2 + 2 * 16 * 72 * 2
                              + 2 * 16 * 4)),
])
def test_bf16_plan_is_the_tensor_core_body(kind, heads, batch, d, hidden,
                                           want):
    plan = cr.rollout_route(kind, heads, batch, d, hidden, H100, 2)
    assert tuple(plan)[:7] == want
    outs = 1 if kind == "crvae" else d
    assert plan.smem == cr.resident_smem_bytes(
        plan.heads_per_block, plan.bt, d, hidden, outs, kind == "crvae", 2)
    assert plan.smem <= H100[0]
    assert plan.bt % cr.MMA_ROWS == 0
    assert cr.mma_items(plan.heads_per_block, plan.bt, hidden) == (
        plan.heads_per_block * plan.bt // 16 * -(-hidden // 8))


def test_ops_are_the_wrappers(pair):
    """The custom ops run the wrappers (on the CPU their plain versions)."""
    _, (m, e, tp, tep) = pair
    g = torch.Generator().manual_seed(1)
    h0 = torch.randn((3, H), generator=g)
    noise = torch.randn((3, 5, P), generator=g)
    x0 = torch.zeros((3, P))
    for heads, ro in ((tp.heads, tp.readout),
                      tuple(cr.cast_weights(w, BF) for w in (tp.heads,
                                                             tp.readout))):
        got = torch.ops.vae_connexe.crvae_free_run(
            heads.w_ih, heads.w_hh, heads.b_ih, heads.b_hh, ro.w, ro.b, x0,
            h0, noise, 0.1)
        torch.testing.assert_close(got, cr.crvae_free_run_fused(
            heads, ro, x0, h0, noise, 0.1), rtol=0, atol=0)
    got = torch.ops.vae_connexe.errvae_sample(
        tep.dec.w_ih, tep.dec.w_hh, tep.dec.b_ih, tep.dec.b_hh, tep.out.w,
        tep.out.b, h0, P, 5)
    torch.testing.assert_close(got, cr.errvae_sample_fused(
        tep.dec, tep.out, h0, P, 5), rtol=0, atol=0)


@pytest.mark.parametrize("serve_dtype", ["float32", "bfloat16"])
def test_artifact_round_trip(pair, serve_dtype):
    """An artifact's fn(seed) is in-process generation from a generator of
    that seed, bit for bit on the CPU, in both storage types."""
    _, (m, e, tp, tep) = pair
    blob = export_generator(m, e, tp, tep, batch=8, serve_dtype=serve_dtype)
    fn, meta = load_generator(blob, "cpu")
    assert meta["serve_dtype"] == serve_dtype and meta["platforms"] == ["cpu"]
    want = generate_with_compensation(m, e, tp, tep,
                                      torch.Generator().manual_seed(4), 8,
                                      dtype=serve_dtype)
    np.testing.assert_array_equal(fn(4), want.numpy())
    if serve_dtype == "bfloat16":
        _bf16_not_f32(fn(4), generate_with_compensation(
            m, e, tp, tep, torch.Generator().manual_seed(4), 8))


def test_artifact_runs_without_model_code(pair, tmp_path):
    """A fresh process loads and samples both artifacts importing only the
    loader (torch, numpy, ops/library.py): no model or trainer module."""
    _, (m, e, tp, tep) = pair
    paths = []
    for sd in ("float32", "bfloat16"):
        path = tmp_path / f"g_{sd}.vcxt"
        path.write_bytes(export_generator(m, e, tp, tep, batch=4,
                                          serve_dtype=sd))
        paths.append(str(path))
        np.save(tmp_path / f"want_{sd}.npy",
                generate_with_compensation(m, e, tp, tep,
                                           torch.Generator().manual_seed(3),
                                           4, dtype=sd).numpy())
    code = (
        "import sys, numpy as np\n"
        "from vae_connexe_torch.serving import load_generator\n"
        f"for path, sd in zip({paths!r}, ('float32', 'bfloat16')):\n"
        "    fn, meta = load_generator(path, 'cpu')\n"
        f"    want = np.load({str(tmp_path)!r} + f'/want_{{sd}}.npy')\n"
        "    assert meta['serve_dtype'] == sd\n"
        "    np.testing.assert_array_equal(fn(3), want)\n"
        "print(sorted(k for k in sys.modules if k.startswith(("
        "'vae_connexe_torch.models', 'vae_connexe_torch.train', "
        "'vae_connexe_torch.configs', 'jax', 'vae_connexe_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_old_layout_and_platforms_raise(pair):
    _, (m, e, tp, tep) = pair
    with pytest.raises(ValueError, match="re-export"):
        load_generator(b"VCXTORC1" + bytes(16), "cpu")
    cuda_only = export_generator(m, e, tp, tep, batch=2, platforms=["cuda"])
    with pytest.raises(ValueError, match=r"runs on \['cuda'\], not on cpu"):
        load_generator(cuda_only, "cpu")
    both = export_generator(m, e, tp, tep, batch=2, platforms=["CUDA", "cpu"])
    fn, meta = load_generator(both, "cpu")
    assert meta["platforms"] == ["cuda", "cpu"] and fn(0).shape == (2, 21, P)
    with pytest.raises(ValueError, match="platforms"):
        export_generator(m, e, tp, tep, batch=2, platforms=["tpu"])


def test_win_generate_and_artifact_bf16():
    """The win generate's float32 path is unchanged by the dtype spelling;
    its bf16 loop stays within the bounds of the float32 one; the bf16
    artifact is the in-process bf16 generate (the encoder, B1's plain
    version in the artifact and ``gru_scan`` in process, sums in another
    order on the CPU)."""
    m = WInCRVAE(d=4, hidden=16, latent=8, tau=5)
    tp = m.init(torch.Generator().manual_seed(0), "cpu")
    ctx = np.random.default_rng(1).normal(size=(32, 5, 4)).astype(np.float32)
    eps = torch.randn((32, 8), generator=torch.Generator().manual_seed(2))
    f32 = m.generate(tp, _t(ctx), None, 6, eps=eps)
    torch.testing.assert_close(
        m.generate(tp, _t(ctx), None, 6, dtype="float32", eps=eps), f32,
        rtol=0, atol=0)
    got = m.generate(tp, _t(ctx), None, 6, dtype=torch.bfloat16, eps=eps)
    _close_in_distribution(got, f32)
    _bf16_not_f32(got, f32)
    fn, meta = load_generator(export_win_generator(
        m, tp, batch=32, length=6, serve_dtype="bfloat16"), "cpu")
    assert meta["serve_dtype"] == "bfloat16" and meta["latent"] == 8
    ref = m.generate(tp, _t(ctx), torch.Generator().manual_seed(5), 6,
                     dtype="bfloat16")
    _close_in_distribution(fn(5, ctx), ref.numpy())


def test_artifact_buffers_hold_the_storage_type(pair):
    """A bf16 artifact stores its rollout weights in bf16 (half the
    bytes), its float32 one in float32."""
    _, (m, e, tp, tep) = pair
    sizes = {sd: len(export_generator(m, e, tp, tep, batch=2,
                                      serve_dtype=sd))
             for sd in ("float32", "bfloat16")}
    weights = sum(t.numel() for g in (tp.heads, tp.readout, tep.dec, tep.out)
                  for t in (getattr(g, f.name)
                            for f in dataclasses.fields(g)))
    assert sizes["float32"] - sizes["bfloat16"] >= 2 * weights * 0.95
