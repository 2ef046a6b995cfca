"""The port's kernel wrappers (plain versions on CPU tensors) against
the Pallas kernels in interpret mode, on the same numpy inputs: flash
attention, the SSD chunked scan, the ring all-gather and the MoE grouped
matmul.

The CUDA kernels themselves run only on the card: ``chip_smoke.py``
holds them against their plain versions there."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as flash_pallas  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as gmm_pallas  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402

from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.core import ranks  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import moe_gmm as tgmm  # noqa: E402
from repro_torch.kernels import ring_allgather as tring  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the cases of tests/test_kernels.py, plus one-row and 7-row prompts
FLASH_CASES = [
    # (b, hq, hkv, sq, sk, dk, dv, causal, dtype)
    (2, 4, 2, 128, 128, 64, 64, True, "float32"),
    (1, 8, 8, 256, 256, 128, 128, True, "float32"),
    (2, 4, 2, 64, 192, 32, 32, False, "float32"),
    (1, 6, 2, 96, 96, 64, 32, True, "float32"),
    (1, 4, 4, 128, 128, 64, 64, True, "bfloat16"),
    (2, 2, 1, 64, 64, 16, 16, False, "bfloat16"),
    (1, 14, 2, 7, 7, 64, 64, True, "float32"),
    (1, 14, 2, 1, 1, 64, 64, True, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}     # as tests/test_kernels.py


def _inputs(seed, b, hq, hkv, sq, sk, dk, dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, dk), np.float32),
            rng.standard_normal((b, hkv, sk, dk), np.float32),
            rng.standard_normal((b, hkv, sk, dv), np.float32))


def _both(arrs, dtype):
    """The same numpy values as jax and torch arrays of ``dtype`` (both
    round float32 to bfloat16 to nearest even)."""
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_flash_matches_pallas_interpret(case):
    b, hq, hkv, sq, sk, dk, dv, causal, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(sum(case[:7]), b, hq, hkv, sq, sk, dk, dv), dtype)
    want = flash_pallas(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                        interpret=True)
    n0 = tfa.launches
    got = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert tfa.launches == n0            # the CPU path launches nothing
    assert got.dtype == tv.dtype and tuple(got.shape) == (b, hq, sq, dv)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])


def test_causal_mask_is_top_left_aligned_like_pallas():
    """With Sq != Sk the Pallas kernel keeps key j for row i when i >= j
    (top-left); ref.py keeps j <= i + Sk - Sq (bottom-right).  The port's
    plain version follows the kernel, its ref.py follows the reference's
    ref.py, and the two differ."""
    b, hq, hkv, sq, sk, d = 1, 4, 2, 32, 96, 16
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(7, b, hq, hkv, sq, sk, d, d),
                                       "float32")
    pallas = flash_pallas(jq, jk, jv, causal=True, block_q=16, block_k=32,
                          interpret=True)
    plain = tfa.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_np(plain), _np(pallas), atol=2e-5)
    bottom_right = tref.flash_attention_ref(tq, tk, tv, causal=True)
    np.testing.assert_allclose(
        _np(bottom_right), _np(jref.flash_attention_ref(jq, jk, jv,
                                                        causal=True)),
        atol=2e-5)
    assert np.abs(_np(bottom_right) - _np(plain)).max() > 1e-2
    # with Sq == Sk the two masks agree
    sq_eq = tfa.flash_attention(tq, tk[:, :, :sq], tv[:, :, :sq])
    np.testing.assert_allclose(
        _np(sq_eq), _np(tref.flash_attention_ref(tq, tk[:, :, :sq],
                                                 tv[:, :, :sq])), atol=2e-5)


def test_model_kernels_hook_matches_model_layout():
    """The hook takes the model's seq-major layout, as
    tests/test_kernels.py::test_model_kernels_hooks_match_model_layout."""
    kw = dict(n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              vocab=64, q_block=16)
    jhook = jops.model_kernels(JConfig(dtype=jnp.float32,
                                       param_dtype=jnp.float32, **kw),
                               backend="pallas")["flash_attention"]
    thook = tops.model_kernels(TConfig(dtype=torch.float32,
                                       param_dtype=torch.float32, **kw)
                               )["flash_attention"]
    rng = np.random.default_rng(3)
    b, s = 2, 64
    arrs = [rng.standard_normal((b, s, h, 16), np.float32)
            for h in (4, 2, 2)]
    want = jhook(*[jnp.asarray(a) for a in arrs], causal=True, scale=0.25)
    got = thook(*[torch.from_numpy(a) for a in arrs], causal=True,
                scale=0.25)
    assert tuple(got.shape) == (b, s, 4, 16)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_takes_strided_views(case):
    """q, k, v as the model's attention hook passes them: transposed views
    of [B, S, H, D] tensors.  The wrapper returns what it returns for their
    contiguous copies, and the Pallas kernel's result on the same values."""
    b, hq, hkv, sq, sk, dk, dv, causal, dtype = case
    arrs = [a.transpose(0, 2, 1, 3).copy() for a in
            _inputs(sum(case[:7]) + 1, b, hq, hkv, sq, sk, dk, dv)]
    (jq, jk, jv), seq_major = _both(arrs, dtype)
    views = [t.transpose(1, 2) for t in seq_major]
    assert sq == 1 or not views[0].is_contiguous()
    got = tfa.flash_attention(*views, causal=causal)
    want = tfa.flash_attention(*[t.contiguous() for t in views],
                               causal=causal)
    assert torch.equal(got, want)
    pallas = flash_pallas(*[x.transpose(0, 2, 1, 3) for x in (jq, jk, jv)],
                          causal=causal, block_q=64, block_k=64,
                          interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_kernels_hook_passes_views_without_copies(dtype,
                                                       monkeypatch):
    """The hook hands the kernel the transposed views with no copy and
    gives what the hook with contiguous copies gave."""
    kw = dict(n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              vocab=64, q_block=16)
    dt = getattr(torch, dtype)
    hook = tops.model_kernels(TConfig(dtype=dt, param_dtype=dt, **kw)
                              )["flash_attention"]
    rng = np.random.default_rng(4)
    q, k, v = [torch.from_numpy(rng.standard_normal((2, 40, h, 16),
                                                    np.float32)).to(dt)
               for h in (4, 2, 2)]
    before = tfa.flash_attention(q.transpose(1, 2).contiguous(),
                                 k.transpose(1, 2).contiguous(),
                                 v.transpose(1, 2).contiguous(),
                                 causal=True, scale=0.25).transpose(1, 2)
    seen = []
    real = tfa.flash_attention

    def spy(*args, **kwargs):
        seen.extend(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(tops, "flash_attention", spy)
    got = hook(q, k, v, causal=True, scale=0.25)
    assert [a.data_ptr() for a in seen] == [t.data_ptr() for t in (q, k, v)]
    assert torch.equal(got, before)


def test_wrapper_never_falls_back_for_other_devices():
    """Only CPU tensors take the plain version: a tensor on any other
    device goes to the kernel or raises."""
    q = torch.zeros((1, 2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("bad", ["rank", "dtype", "groups", "mixed"])
def test_wrapper_checks_inputs(bad):
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    if bad == "rank":
        args, err = (q[0], k[0], k[0]), ValueError
    elif bad == "dtype":
        args, err = (q.half(), k.half(), k.half()), TypeError
    elif bad == "groups":
        args, err = (q[:, :3], k, k), ValueError
    else:
        args, err = (q, k.bfloat16(), k), TypeError
    with pytest.raises(err):
        tfa.flash_attention(*args)


# the cases of tests/test_kernels.py, plus a prime length (the Pallas
# wrapper's chunk falls to one row, the port keeps 64 and masks the
# tail) and a one-row prompt
SSD_CASES = [
    # (b, s, h, p, n, chunk, dtype)
    (2, 64, 3, 16, 8, 16, "float32"),
    (1, 128, 2, 32, 16, 32, "float32"),
    (1, 32, 4, 8, 4, 8, "float32"),
    (2, 64, 2, 16, 8, 16, "bfloat16"),
    (1, 37, 2, 16, 8, 16, "float32"),
    (1, 1, 2, 16, 8, 16, "float32"),
]
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}  # as tests/test_kernels.py


def _ssd_inputs(seed, b, s, h, p, n, dtype):
    """(x, dt, A, B, C) as jax and torch arrays; dt and A float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bm = rng.standard_normal((b, s, h, n), np.float32)
    Cm = rng.standard_normal((b, s, h, n), np.float32)
    (jx, jb, jc), (tx, tb, tc) = _both((x, Bm, Cm), dtype)
    return ((jx, jnp.asarray(dt), jnp.asarray(A), jb, jc),
            (tx, torch.from_numpy(dt), torch.from_numpy(A), tb, tc))


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_ssd_scan_matches_pallas_interpret(case):
    b, s, h, p, n, chunk, dtype = case
    j, t = _ssd_inputs(s + h + p, b, s, h, p, n, dtype)
    want_y, want_h = jops.ssd_scan(*j, chunk=chunk, backend="pallas")
    gold_y, gold_h = jref.ssd_scan_ref(*j, chunk)
    n0 = tssd.launches
    for fn in (tssd.ssd_scan_plain, tops.ssd_scan):
        y, hf = fn(*t)
        assert y.dtype == t[0].dtype and tuple(y.shape) == (b, s, h, p)
        assert hf.dtype == torch.float32 and tuple(hf.shape) == (b, h, n, p)
        for got, want in ((y, want_y), (hf, want_h), (y, gold_y),
                          (hf, gold_h)):
            np.testing.assert_allclose(_np(got), _np(want),
                                       atol=SSD_TOL[dtype])
    assert tssd.launches == n0           # the CPU path launches nothing
    ry, rh = tref.ssd_scan_ref(*t)
    np.testing.assert_allclose(_np(ry), _np(gold_y), atol=SSD_TOL[dtype])
    np.testing.assert_allclose(_np(rh), _np(gold_h), atol=SSD_TOL[dtype])


# chip_smoke.py's bounds for the CUDA kernel in bf16: y within (atol,
# rtol), h_final (f32) within an absolute 1e-4
CHIP_SSD_TOL = (1e-2, 1e-2)
CHIP_SSD_H_ATOL = 1e-4


def _split(t):
    """An f32 operand as the CUDA kernel feeds it to bf16 tensor cores:
    hi = bf16(t), lo = bf16(t - hi), each back in f32 (the products of
    two bf16 values are exact in the f32 sums)."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _ssd_kernel_scheme(x, dt, A, Bm, Cm, cs=64):
    """``csrc/ssd_scan.cu``'s bf16 arithmetic in plain PyTorch, phase by
    phase: (1) each chunk's state, B^T (coef x) with coef x split;
    (2) the pass over chunk states in f32; (3) C B^T from the bf16
    inputs, w split, y = w x + exp(cum) (C h) with h split and the row
    decay applied after the product.  Chunks of ``cs`` rows, the tail as
    dt = 0 and x = B = C = 0."""
    b, s, h, p = x.shape
    nc = -(-s // cs)

    def chunks(t):
        t = torch.nn.functional.pad(t.float(),
                                    (0, 0) * (t.dim() - 2) + (0, nc * cs - s))
        return t.reshape((b, nc, cs) + tuple(t.shape[2:]))

    xs, dts, Bs, Cs = map(chunks, (x, dt, Bm, Cm))
    cum = torch.cumsum(dts * A, dim=2)                  # [b,nc,cs,h]
    cum_last = cum[:, :, -1:]
    # phase 1
    xh, xl = _split((torch.exp(cum_last - cum) * dts)[..., None] * xs)
    states = sum(torch.einsum("bcjhn,bcjhp->bchnp", Bs, part)
                 for part in (xh, xl))
    gamma = torch.exp(cum_last[:, :, 0])                # [b,nc,h]
    # phase 2
    hstate = torch.zeros((b, h, Bm.shape[-1], p))
    h_in = []
    for c in range(nc):
        h_in.append(hstate)
        hstate = hstate * gamma[:, c, :, None, None] + states[:, c]
    # phase 3
    ct = cum.transpose(2, 3)
    tri = torch.ones(cs, cs, dtype=torch.bool).tril()
    w = (torch.einsum("bcihn,bcjhn->bchij", Cs, Bs)
         * torch.exp((ct[..., :, None] - ct[..., None, :])
                     .masked_fill(~tri, float("-inf")))
         * dts.transpose(2, 3)[..., None, :])
    y = sum(torch.einsum("bchij,bcjhp->bcihp", part, xs)
            for part in _split(w))
    off = sum(torch.einsum("bcihn,bchnp->bcihp", Cs, part)
              for part in _split(torch.stack(h_in, dim=1)))
    y = y + off * torch.exp(cum)[..., None]
    return y.reshape(b, nc * cs, h, p)[:, :s].to(x.dtype), hstate


@pytest.mark.parametrize("s", [1, 65, 257])
def test_ssd_kernel_scheme_fits_chip_bounds(s):
    """The CUDA kernel's operand rounding (bf16 high/low splits of the
    three f32 operands) at mamba2-130m's widths (H = 24, P = 64, N = 128,
    one group shared by the heads, bf16, the mixer's value scales as
    chip_smoke.py draws them) against the Pallas kernel in interpret
    mode, within the bounds chip_smoke.py holds the kernel to."""
    b, h, p, n = 1, 24, 64, 128
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2.0)
                  ).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    bc = 0.3 * rng.standard_normal((2, b, s, 1, n)).astype(np.float32)
    Bm, Cm = (np.ascontiguousarray(np.broadcast_to(t, (b, s, h, n)))
              for t in bc)
    (jx, jb, jc), (tx, tb, tc) = _both((x, Bm, Cm), "bfloat16")
    want_y, want_h = jops.ssd_scan(jx, jnp.asarray(dt), jnp.asarray(A), jb,
                                   jc, chunk=64, backend="pallas")
    y, hf = _ssd_kernel_scheme(tx, torch.from_numpy(dt),
                               torch.from_numpy(A), tb, tc)
    assert y.dtype == torch.bfloat16
    atol, rtol = CHIP_SSD_TOL
    want_y = _np(want_y)
    assert (np.abs(_np(y) - want_y) <= atol + rtol * np.abs(want_y)).all()
    assert np.abs(_np(hf) - _np(want_h)).max() <= CHIP_SSD_H_ATOL


def test_ssd_hook_matches_model_layout():
    """The ``ssd_scan`` hook takes the model's layout and the chunk, as
    the reference's hook does."""
    kw = dict(n_layers=1, d_model=32, n_heads=1, n_kv_heads=1, d_ff=0,
              vocab=64, family="ssm", ssm_state=8, ssm_head_dim=8,
              ssm_chunk=16)
    jhook = jops.model_kernels(JConfig(dtype=jnp.float32,
                                       param_dtype=jnp.float32, **kw),
                               backend="pallas")["ssd_scan"]
    thook = tops.model_kernels(TConfig(dtype=torch.float32,
                                       param_dtype=torch.float32, **kw)
                               )["ssd_scan"]
    j, t = _ssd_inputs(5, 2, 48, 8, 8, 8, "float32")
    want = jhook(*j, chunk=16)
    got = thook(*t, chunk=16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-4)


def test_ssd_wrapper_never_falls_back_for_other_devices():
    """Only CPU tensors take the plain version: a tensor on any other
    device goes to the kernel or raises."""
    x = torch.zeros((1, 4, 2, 8), device="meta")
    dt = torch.zeros((1, 4, 2), device="meta")
    A = torch.zeros((2,), device="meta")
    with pytest.raises(ValueError, match="no SSD-scan kernel"):
        tssd.ssd_scan(x, dt, A, x, x)


@pytest.mark.parametrize("bad", ["rank", "dtype", "dt_dtype", "shape",
                                 "mixed"])
def test_ssd_wrapper_checks_inputs(bad):
    x = torch.zeros((1, 4, 2, 8))
    dt, A, bm = torch.zeros((1, 4, 2)), torch.zeros((2,)), torch.zeros(
        (1, 4, 2, 6))
    args, err = {
        "rank": ((x[0], dt, A, bm, bm), ValueError),
        "dtype": ((x.half(), dt, A, bm.half(), bm.half()), TypeError),
        "dt_dtype": ((x, dt.double(), A, bm, bm), TypeError),
        "shape": ((x, dt[:, :3], A, bm, bm), ValueError),
        "mixed": ((x, dt, A, bm.bfloat16(), bm), TypeError),
    }[bad]
    with pytest.raises(err):
        tssd.ssd_scan(*args)


# -- ring all-gather ---------------------------------------------------------
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def test_plain_ring_allgather_matches_pallas_interpret():
    """The Pallas ring kernel under shard_map over n of 8 forced host
    devices (interpret mode, as tests/test_multidevice.py runs it) against
    ``ring_all_gather`` on a CPU tensor, bit for bit, for n in {2, 4, 8}
    and float32 / bfloat16 / int32."""
    from repro.kernels.ring_allgather import tpu_interpret_available
    if not tpu_interpret_available():
        pytest.skip("this JAX lacks the pltpu TPU interpret machinery")
    code = textwrap.dedent("""
        import jax, jax.numpy as jnp, numpy as np, torch
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.compat import shard_map
        from repro.kernels.ring_allgather import ring_all_gather
        from repro_torch.kernels import ring_allgather as tring
        rng = np.random.default_rng(0)
        for n in (2, 4, 8):
            mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
            f = jax.jit(shard_map(
                lambda s: ring_all_gather(s, "x", axis_size=n), mesh,
                in_specs=P("x", None), out_specs=P("x", None)))
            for dt in ("float32", "bfloat16", "int32"):
                x = rng.integers(-999, 999, (n, 24)).astype(np.float32)
                jx = jnp.asarray(x).astype(dt)
                want = np.asarray(f(jx)).reshape(n, n, 24)
                tx = torch.from_numpy(x).to(getattr(torch, dt))
                got = tring.ring_all_gather(tx[:, None])
                assert tring.launches == 0
                if dt == "bfloat16":
                    want = want.view(np.uint16)
                    got = got.view(torch.int16).numpy().view(np.uint16)
                else:
                    got = got.numpy()
                assert got.dtype == want.dtype, (got.dtype, want.dtype)
                assert (got == want).all(), (n, dt)
                print("ok", n, dt)
        """)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=420)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nERR:\n{out.stderr}"
    assert out.stdout.count("ok") == 9


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("rest", [(), (3,), (2, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_plain_ring_allgather_matches_reference_oracle(n, rest, dtype):
    """``ring_all_gather`` on a CPU tensor against the reference's
    ``ring_allgather_ref`` (``lax.all_gather`` under vmap) and the port's
    oracle, bit for bit."""
    rng = np.random.default_rng(n)
    x = rng.integers(-999, 999, (n, 1) + rest).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax.vmap(lambda s: jref.ring_allgather_ref(s, "x"),
                               axis_name="x")(jx)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tring.ring_all_gather(tx)
    assert got.dtype == tx.dtype and tuple(got.shape) == (n, n) + rest
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(got, tref.ring_allgather_ref(tx))
    assert torch.equal(got, tring.ring_all_gather_plain(tx))


def test_ring_wrapper_never_falls_back_for_other_devices():
    """Only CPU tensors take the plain version: a tensor on any other
    device goes to the kernel or raises."""
    x = torch.zeros((4, 1, 8), device="meta")
    with pytest.raises(ValueError, match="no ring all-gather kernel"):
        tring.ring_all_gather(x)
    assert tring.launches == 0


@pytest.mark.parametrize("shape", [(4,), (4, 2, 8), (0, 1, 8)])
def test_ring_wrapper_checks_inputs(shape):
    with pytest.raises(ValueError, match="rank-stacked"):
        tring.ring_all_gather(torch.zeros(shape))


def test_ring_all_gather_op_checks_the_axis():
    """``ops.ring_all_gather`` (the reference's entry point) needs x's
    ranks to match ``axis_size`` and the axis to be bound to it."""
    x = torch.arange(8.0).reshape(4, 1, 2)
    with ranks.bind_axis("x", 4):
        out = tops.ring_all_gather(x, "x", axis_size=4)
        assert torch.equal(out, tref.ring_allgather_ref(x))
        with pytest.raises(ValueError, match="axis_size"):
            tops.ring_all_gather(x, "x", axis_size=2)
    with ranks.bind_axis("x", 2), pytest.raises(ValueError, match="bound"):
        tops.ring_all_gather(x, "x", axis_size=4)
    with pytest.raises(NameError):
        tops.ring_all_gather(x, "y", axis_size=4)


# The CUDA kernel's plan (``tring.plan``): chip_smoke.py's shard sizes,
# odd ones, and starts misaligned by 2, 4 and 8 bytes.  The kernel walks
# the plan's tiles (vectors) and each shard's head and tail (bytes); see
# csrc/ring_allgather.cu.
RING_SHARD_BYTES = (1, 3, 4, 6, 8, 17, 4096, 4097, 1 << 20, 64 << 20)
RING_MODS = [(0, 0), (2, 0), (4, 0), (8, 0), (0, 2), (0, 8), (2, 2),
             (4, 4), (8, 8), (2, 8), (8, 4)]
SMS = 132                                      # an H100 SXM's SMs


def _ring_walk(p, n):
    """The kernel's walk along plan ``p``, as ``(i, lo, hi, vec)``: shard
    i's bytes ``[lo, hi)`` go to ``out[r, i]`` for every r, in vectors of
    ``vec`` bytes; tiles first, then the byte path's heads and tails."""
    for t in range(n * p.tiles_per_shard):
        i, k = divmod(t, p.tiles_per_shard)
        lo = p.head + k * p.tile
        yield i, lo, min(lo + p.tile, p.head + p.body), p.vec
    for i in range(n):
        yield i, 0, p.head, 1
        yield i, p.head + p.body, p.head + p.body + p.tail, 1


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("shard", RING_SHARD_BYTES)
def test_ring_plan_covers_every_byte_once(n, shard):
    """Every byte of every destination ``out[r, i]`` is written exactly
    once, every vector is aligned in ``x`` and in each ``out[r, i]``, a
    16-byte body goes by TMA, and no block gets more than one tile."""
    for x_mod, out_mod in RING_MODS:
        p = tring.plan(n, shard, x_mod, out_mod, SMS)
        assert p.head + p.body + p.tail == shard
        assert p.tma == (p.vec == 16) and p.tile % tring.TILE_ALIGN == 0
        assert 1 <= p.grid <= tring.BLOCKS_PER_SM * SMS
        assert n * p.tiles_per_shard <= p.grid or p.tiles_per_shard == 1
        ranges = {i: [] for i in range(n)}
        for i, lo, hi, vec in _ring_walk(p, n):
            if lo == hi:
                continue
            assert 0 <= lo < hi <= shard and (hi - lo) % vec == 0
            assert (x_mod + i * shard + lo) % vec == 0
            assert all((out_mod + (r * n + i) * shard + lo) % vec == 0
                       for r in range(n))
            ranges[i].append((lo, hi))
        for i in range(n):
            covered = sorted(ranges[i])
            assert covered[0][0] == 0 and covered[-1][1] == shard
            assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))


def test_ring_plan_fsdp_shape_goes_by_tma():
    """The FSDP gather's shape (a qwen2-0.5b layer of 14,912,384 bf16
    params over 8 ranks) takes 16-byte vectors by TMA, with no byte path,
    on one wave of equal tiles."""
    p = tring.plan(8, 14_912_384 // 8 * 2, 0, 0, SMS)
    assert p.tma and p.vec == 16 and p.head == p.tail == 0
    assert 8 * p.tiles_per_shard == p.grid <= tring.BLOCKS_PER_SM * SMS
    assert tring.plan(8, 14_912_384 // 8 * 2, 2, 0, SMS).vec == 2


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", ["uint8", "bfloat16", "float32", "int32"])
def test_ring_walk_matches_plain(n, dtype):
    """The kernel's walk along its plan, emulated by byte slicing of CPU
    tensors (x and out at offsets into larger buffers), equals
    ``ring_all_gather_plain`` bit for bit."""
    dt = getattr(torch, dtype)
    esz = torch.empty((), dtype=dt).element_size()
    rng = np.random.default_rng(n)
    for shard in (1, 3, 4, 6, 8, 17, 4096, 4097, 12_304):
        if shard % esz:
            continue
        for x_off, out_off in ((0, 0), (2, 0), (4, 0), (8, 0), (8, 4),
                               (2, 2)):
            if x_off % esz or out_off % esz:
                continue
            xbuf = torch.from_numpy(rng.integers(
                0, 256, n * shard + 64, dtype=np.uint8))
            base = -xbuf.data_ptr() % 16     # the buffer's 16-byte start
            xb = xbuf[base + x_off:base + x_off + n * shard]
            obuf = torch.zeros(n * n * shard + 64, dtype=torch.uint8)
            ob = obuf[-obuf.data_ptr() % 16 + out_off:][:n * n * shard]
            p = tring.plan(n, shard, xb.data_ptr() % 16, ob.data_ptr() % 16,
                           SMS)
            for i, lo, hi, _ in _ring_walk(p, n):
                for r in range(n):
                    dst = (r * n + i) * shard
                    ob[dst + lo:dst + hi] = xb[i * shard + lo:i * shard + hi]
            x = xb.view(dt).reshape(n, 1, -1)
            want = tring.ring_all_gather_plain(x)
            got = ob.view(dt).reshape(want.shape)
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


class _AsCuda:
    """A CPU tensor that reports a CUDA device, so that the wrapper's CUDA
    branch runs on the CPU up to the kernel call."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)

    def __getitem__(self, k):
        return self._t[k]


class _TorchOnCpu:
    """``torch`` as the wrapper sees it: ``empty`` recorded and made on
    the CPU, ``cuda.device`` and the current stream stubbed."""

    def __init__(self):
        self.empty_calls = []
        self.cuda = type("cuda", (), {
            "device": staticmethod(lambda d: __import__(
                "contextlib").nullcontext()),
            "current_stream": staticmethod(lambda: type(
                "stream", (), {"cuda_stream": 0})())})

    def __getattr__(self, name):
        return getattr(torch, name)

    def empty(self, *shape, dtype=None, device=None):
        self.empty_calls.append((tuple(*shape), dtype, device))
        return torch.empty(*shape, dtype=dtype)


@pytest.mark.parametrize("n,rest,dtype", [(8, (1000,), "bfloat16"),
                                          (3, (5, 3), "float32"),
                                          (2, (3,), "uint8")])
def test_ring_wrapper_allocates_only_out(monkeypatch, n, rest, dtype):
    """On a CUDA tensor the wrapper allocates ``out`` and nothing else (no
    flag buffer), and hands the kernel one plan, once."""
    fake = _TorchOnCpu()
    calls = []
    monkeypatch.setattr(tring, "torch", fake)
    monkeypatch.setattr(tring, "launches", 0)
    monkeypatch.setattr(tring, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(tring, "_kernel",
                        lambda: lambda *a: calls.append(a) or 0)
    x = torch.zeros((n, 1) + rest, dtype=getattr(torch, dtype))
    out = tring.ring_all_gather(_AsCuda(x))
    assert fake.empty_calls == [((n, n) + rest, x.dtype,
                                 torch.device("cuda", 0))]
    assert tuple(out.shape) == (n, n) + rest and tring.launches == 1
    shard = x[0].numel() * x.element_size()
    p = tring.plan(n, shard, x.data_ptr() % 16, out.data_ptr() % 16, SMS)
    assert calls == [(x.data_ptr(), out.data_ptr(), n, shard, p.vec,
                      p.head, p.body, p.tile, p.grid, int(p.tma), 0)]
    assert not hasattr(tring, "MAX_BLOCKS_PER_RANK")


def test_ring_wrapper_raises_on_a_failed_launch_or_strided_x(monkeypatch):
    monkeypatch.setattr(tring, "torch", _TorchOnCpu())
    monkeypatch.setattr(tring, "launches", 0)
    monkeypatch.setattr(tring, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(tring, "_kernel", lambda: lambda *a: 1)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        tring.ring_all_gather(_AsCuda(torch.zeros((4, 1, 8))))
    strided = torch.zeros((4, 1, 8, 2)).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tring.ring_all_gather(_AsCuda(strided))
    assert tring.launches == 0


# tests/test_kernels.py's cases, plus ragged ones (C, d, f not multiples
# of anything: the Pallas wrapper halves its blocks to divisors, the CUDA
# kernel masks the edges)
GMM_CASES = [
    # (e, c, d, f, dtype)
    (4, 64, 96, 80, "float32"),
    (2, 128, 64, 64, "float32"),
    (8, 32, 48, 32, "bfloat16"),
    (1, 256, 128, 256, "float32"),
    (4, 24, 80, 96, "bfloat16"),
    (3, 5, 100, 7, "float32"),
]
GMM_TOL = {"float32": 1e-4, "bfloat16": 1e-1}  # as tests/test_kernels.py


@pytest.mark.parametrize("case", GMM_CASES)
def test_plain_moe_gmm_matches_pallas_interpret(case):
    """The plain version, the CPU wrapper, the oracle and the model hook
    against ``_gmm_kernel`` in interpret mode (32-wide blocks, as
    tests/test_kernels.py runs it)."""
    e, c, d, f, dtype = case
    rng = np.random.default_rng(e * c + d)
    xb = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    jx, jw = jnp.asarray(xb, dtype), jnp.asarray(w, dtype)
    tx = torch.from_numpy(xb).to(getattr(torch, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    want = np.asarray(gmm_pallas(jx, jw, block_c=32, block_f=32, block_d=32,
                                 interpret=True), np.float32)
    before = tgmm.launches
    hook = tops.model_kernels(None)["moe_gmm"]
    for got in (tgmm.moe_gmm_plain(tx, tw), tgmm.moe_gmm(tx, tw),
                tref.moe_gmm_ref(tx, tw), hook(tx, tw)):
        assert got.dtype == tx.dtype and tuple(got.shape) == (e, c, f)
        np.testing.assert_allclose(_np(got), want, atol=GMM_TOL[dtype],
                                   rtol=1e-2)
    assert tgmm.launches == before


def test_gmm_wrapper_never_falls_back_for_other_devices():
    """Only CPU tensors take the plain version: a tensor on any other
    device goes to the kernel or raises."""
    x = torch.zeros((2, 8, 16), device="meta")
    w = torch.zeros((2, 16, 4), device="meta")
    with pytest.raises(ValueError, match="no grouped-matmul kernel"):
        tgmm.moe_gmm(x, w)
    assert tgmm.launches == 0


@pytest.mark.parametrize("bad", ["rank", "experts", "depth", "dtype",
                                 "mixed"])
def test_gmm_wrapper_checks_inputs(bad):
    x = torch.zeros((2, 8, 16))
    w = torch.zeros((2, 16, 4))
    args, err = {
        "rank": ((x[0], w), ValueError),
        "experts": ((x, w[:1]), ValueError),
        "depth": ((x[:, :, :8], w), ValueError),
        "dtype": ((x.half(), w.half()), TypeError),
        "mixed": ((x, w.bfloat16()), TypeError)}[bad]
    with pytest.raises(err):
        tgmm.moe_gmm(*args)


# ---------------------------------------------------------------------------
# GQA decode attention (no TPU kernel: the reference decodes in plain JAX)
# ---------------------------------------------------------------------------
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.common import dense, rope_cos_sin  # noqa: E402

DECODE_SMAX = 40
DECODE_LENGTHS = {"zero": [0, 0, 0], "one": [1, 1, 1],
                  "mixed": [0, 17, 38], "last": [39, 39, 39]}


def _decode_case(seed, g, hd, window, qk_norm, hkv=2, b=3):
    """(cfg, params, x [B,1,D] bf16, cache k/v with random rows)."""
    cfg = TConfig(name="decode", n_layers=1, d_model=32, n_heads=g * hkv,
                  n_kv_heads=hkv, head_dim=hd, d_ff=64, vocab=16,
                  qk_norm=qk_norm, sliding_window=window,
                  rope_theta=1e4, dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(seed)
    p = tattn.attn_init(gen, cfg, torch.device("cpu"))
    if qk_norm:   # gains other than 1, so the norm shows
        for key in ("qnorm", "knorm"):
            p[key]["g"] = (1 + 0.5 * torch.randn(hd, generator=gen)
                           ).to(torch.bfloat16)
    x = torch.randn((b, 1, cfg.d_model), generator=gen).to(torch.bfloat16)
    shape = (b, DECODE_SMAX, hkv, hd)
    cache = {n: torch.randn(shape, generator=gen).to(torch.bfloat16)
             for n in ("k", "v")}
    return cfg, p, x, cache


@pytest.mark.parametrize("lengths", sorted(DECODE_LENGTHS))
@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("g", [1, 4, 6, 7, 12])
def test_plain_decode_attention_equals_attn_decode(g, hd, lengths):
    """The kernel's plain twin, fed the un-roped projections and the
    step's cos / sin computed once, gives ``attn_decode``'s plain output
    and writes the same cache rows, bit for bit: with and without a window
    shorter than some lengths, with and without qk_norm."""
    lens = torch.tensor(DECODE_LENGTHS[lengths], dtype=torch.int32)
    for window, qk_norm in [(None, False), (9, False), (None, True),
                            (9, True)]:
        cfg, p, x, cache = _decode_case(g * 100 + hd, g, hd, window, qk_norm)
        want_cache = {n: t.clone() for n, t in cache.items()}
        want, _ = tattn.attn_decode(cfg, p, x, want_cache, lens)
        q, k_new, v_new = tattn._project(cfg, p, x)
        cos, sin = rope_cos_sin(lens, hd, cfg.rope_theta)
        out = tda.decode_attention_plain(q, k_new, v_new, cos, sin,
                                         cache["k"], cache["v"], lens,
                                         scale=hd ** -0.5, window=window)
        got = dense(p["wo"], out.reshape(3, 1, -1))
        assert torch.equal(got, want), (window, qk_norm)
        for n in ("k", "v"):
            assert torch.equal(cache[n], want_cache[n]), (n, window, qk_norm)


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("g,hd", [(6, 128), (7, 64), (12, 128)])
def test_plain_decode_attention_matches_oracle(g, hd, window):
    """The plain twin against ``ref.decode_attention_ref``, a sequence at
    a time in f32: the rows written are the oracle's bit for bit (the
    same f32 RoPE, rounded once), the output within one bf16 step of
    |out| <= max|v| plus the plain version's bf16 ``p`` (2^-8 relative
    each, summed over at most 40 rows)."""
    cfg, p, x, cache = _decode_case(7, g, hd, window, False)
    lens = torch.tensor([0, 17, 38], dtype=torch.int32)
    q, k_new, v_new = tattn._project(cfg, p, x)
    cos, sin = rope_cos_sin(lens, hd, cfg.rope_theta)
    want, k_rows, v_rows = tref.decode_attention_ref(
        q, k_new, v_new, cos, sin, cache["k"], cache["v"], lens,
        scale=hd ** -0.5, window=window)
    got = tda.decode_attention(q, k_new, v_new, cos, sin, cache["k"],
                               cache["v"], lens, scale=hd ** -0.5,
                               window=window)
    rows = torch.arange(3)
    assert torch.equal(cache["k"][rows, lens.long()], k_rows)
    assert torch.equal(cache["v"][rows, lens.long()], v_rows)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=1e-2)


def test_decode_hook_given_where_the_kernel_takes_the_shape():
    """``model_kernels`` gives the ``decode_attention`` hook exactly to
    bf16 configs with GQA layers, a head dim of 64 or 128 and at most 16
    query heads a KV head: every GQA config of the port, a sliding window
    included, and no MLA, SSM or encoder config."""
    from repro_torch.configs.base import get_config, list_archs
    gqa = {"internlm2-20b", "qwen2-0.5b", "qwen3-moe-30b-a3b",
           "llava-next-mistral-7b", "starcoder2-7b", "command-r-plus-104b",
           "jamba-1.5-large-398b"}
    given = {a for a in list_archs()
             if "decode_attention" in tops.model_kernels(get_config(a))}
    assert given == gqa & set(list_archs()) and len(given) == len(gqa)
    base = get_config("internlm2-20b")
    for over in (dict(dtype=torch.float32), dict(head_dim=96),
                 dict(n_heads=136, n_kv_heads=8)):
        cfg = dataclasses.replace(base, **over)
        assert "decode_attention" not in tops.model_kernels(cfg), over
    assert "decode_attention" not in tops.model_kernels(None)


def test_decode_wrapper_never_falls_back_for_other_devices():
    """Only CPU tensors take the plain version: a tensor on any other
    device goes to the kernel or raises."""
    b, hkv, g, hd = 2, 2, 4, 64
    m = dict(device="meta", dtype=torch.bfloat16)
    args = (torch.zeros((b, 1, hkv * g, hd), **m),
            torch.zeros((b, 1, hkv, hd), **m),
            torch.zeros((b, 1, hkv, hd), **m),
            torch.zeros((b, hd // 2), device="meta"),
            torch.zeros((b, hd // 2), device="meta"),
            torch.zeros((b, 8, hkv, hd), **m), torch.zeros((b, 8, hkv, hd), **m),
            torch.zeros(b, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no decode-attention kernel"):
        tda.decode_attention(*args, scale=0.125)
    assert tda.launches == 0


@pytest.mark.parametrize("bad", ["rank", "k_new", "cos", "lengths",
                                 "groups", "mixed"])
def test_decode_wrapper_checks_inputs(bad):
    b, hkv, g, hd, smax = 2, 2, 3, 16, 8
    q = torch.zeros((b, 1, hkv * g, hd))
    kv = torch.zeros((b, 1, hkv, hd))
    cs = torch.zeros((b, hd // 2))
    cache = torch.zeros((b, smax, hkv, hd))
    lens = torch.zeros(b, dtype=torch.int32)
    args = [q, kv, kv, cs, cs, cache, cache, lens]
    if bad == "rank":
        args[0] = q[:, 0]
    elif bad == "k_new":
        args[1] = kv[:, :, :1]
    elif bad == "cos":
        args[3] = torch.zeros((b, hd))
    elif bad == "lengths":
        args[7] = lens[:1]
    elif bad == "groups":
        args[0] = torch.zeros((b, 1, 5, hd))
    else:
        args[5] = torch.zeros((b, smax, hkv, hd), device="meta")
    with pytest.raises(ValueError):
        tda.decode_attention(*args, scale=0.25)
