"""FD core invariants (SURVEY.md §4: unit tier, FD error bound + NumPy oracle)."""
import numpy as np
import jax.numpy as jnp
import pytest

from mused_tpu.ops import fd


def numpy_fd_oracle(a: np.ndarray, ell: int) -> np.ndarray:
    """Classic row-at-a-time FD (Ghashami et al.) as an independent oracle."""
    d = a.shape[1]
    b = np.zeros((2 * ell, d))
    fill = 0
    for row in a:
        if fill == 2 * ell:
            u, s, vt = np.linalg.svd(b, full_matrices=False)
            delta = s[ell] ** 2
            s2 = np.sqrt(np.maximum(s**2 - delta, 0.0))
            b = (s2[:, None] * vt)
            fill = int(np.sum(s2 > 0))
            b[fill:] = 0
        b[fill] = row
        fill += 1
    return b


@pytest.mark.parametrize("m,d,ell", [(200, 64, 16), (500, 100, 25), (64, 32, 8)])
def test_fd_error_bound(rng, m, d, ell):
    a = rng.normal(size=(m, d)).astype(np.float32)
    st = fd.init(ell, d)
    st = fd.update_stream(st, jnp.asarray(a))
    err = float(fd.covariance_error(jnp.asarray(a), st.sketch))
    bound = float(np.linalg.norm(a, "fro") ** 2) / ell
    assert err <= bound * 1.01, f"FD bound violated: {err} > {bound}"
    assert int(st.count) == m


def test_fd_tracked_bound_dominates_true_error(rng):
    a = rng.normal(size=(300, 50)).astype(np.float32)
    st = fd.update_stream(fd.init(20, 50), jnp.asarray(a))
    err = float(fd.covariance_error(jnp.asarray(a), st.sketch))
    assert err <= float(fd.error_bound(st)) * 1.01


def test_fd_low_rank_exact(rng):
    """Rank-r input with r < ell is sketched exactly (delta stays 0)."""
    r, d, ell = 5, 64, 16
    base = rng.normal(size=(r, d)).astype(np.float32)
    coef = rng.normal(size=(200, r)).astype(np.float32)
    a = coef @ base
    st = fd.update_stream(fd.init(ell, d), jnp.asarray(a))
    err = float(fd.covariance_error(jnp.asarray(a), st.sketch))
    scale = float(np.linalg.norm(a.T @ a, 2))
    # f32 Gram+eigh costs ~1% relative accuracy here; the structural claim is
    # that the error is tiny relative to the spectrum, not FD-bound-sized.
    assert err <= 3e-2 * scale
    assert float(st.shrink_loss) <= 3e-2 * scale


def test_fd_matches_oracle_quality(rng):
    """Our block FD should be at least as accurate as the row-wise oracle's bound."""
    a = rng.normal(size=(400, 80)).astype(np.float32)
    ell = 20
    ours = fd.update_stream(fd.init(ell, 80), jnp.asarray(a))
    oracle = numpy_fd_oracle(a.astype(np.float64), ell)
    err_ours = float(fd.covariance_error(jnp.asarray(a), ours.sketch))
    err_oracle = float(np.linalg.norm(a.T @ a - oracle.T @ oracle, 2))
    bound = np.linalg.norm(a, "fro") ** 2 / ell
    assert err_ours <= bound
    assert err_oracle <= bound
    # same ballpark (not a strict ordering — different shrink cadence)
    assert err_ours <= 2.5 * err_oracle + 1e-6


def test_fd_zero_rows_are_noops(rng):
    a = rng.normal(size=(100, 32)).astype(np.float32)
    padded = np.concatenate([a, np.zeros((60, 32), np.float32)], axis=0)
    s1 = fd.update_stream(fd.init(8, 32), jnp.asarray(a))
    s2 = fd.update_stream(fd.init(8, 32), jnp.asarray(padded))
    g1 = np.asarray(s1.sketch.T @ s1.sketch)
    g2 = np.asarray(s2.sketch.T @ s2.sketch)
    np.testing.assert_allclose(g1, g2, rtol=2e-3, atol=2e-3)


def test_fd_incremental_equals_bulk(rng):
    a = rng.normal(size=(300, 40)).astype(np.float32)
    bulk = fd.update_stream(fd.init(10, 40), jnp.asarray(a))
    inc = fd.init(10, 40)
    for piece in np.array_split(a, 7):
        inc = fd.update_stream(inc, jnp.asarray(piece))
    # Not bitwise equal (different chunk boundaries) but same guarantee
    for st in (bulk, inc):
        err = float(fd.covariance_error(jnp.asarray(a), st.sketch))
        assert err <= np.linalg.norm(a, "fro") ** 2 / 10
    assert int(inc.count) == 300


class TestSubspaceShrink:
    """Matmul-only adaptive shrink (fd.shrink_fast / mode="subspace"):
    matmuls only, no per-shrink eigh solver latency,
    rank-ell truncation semantics with an exact-eigh fallback on degenerate
    stacks.  Documented weakness: tie-degenerate (duplicate-heavy) spectra."""

    def test_never_overestimates(self, rng):
        a = rng.normal(size=(256, 128)).astype(np.float32)
        st = fd.update_stream(fd.init(16, 128), jnp.asarray(a), mode="subspace")
        diff = a.T.astype(np.float64) @ a - np.asarray(st.sketch, np.float64).T \
            @ np.asarray(st.sketch, np.float64)
        assert np.linalg.eigvalsh(diff).min() >= -1e-2 * np.abs(diff).max()

    def test_fullrank_quality_matches_eigh(self, rng):
        a = rng.normal(size=(512, 256)).astype(np.float32)
        fast = fd.update_stream(fd.init(32, 256), jnp.asarray(a), mode="subspace")
        exact = fd.update_stream(fd.init(32, 256), jnp.asarray(a))
        e_fast = float(fd.covariance_error(jnp.asarray(a), fast.sketch))
        e_exact = float(fd.covariance_error(jnp.asarray(a), exact.sketch))
        assert e_fast <= 1.3 * e_exact

    def test_degenerate_falls_back_to_exact(self, rng):
        """Rank-deficient stream: the orth-health gate must route every shrink
        to the exact path, matching eigh-level error."""
        base = rng.normal(size=(5, 128)).astype(np.float32)
        a = (rng.normal(size=(256, 5)).astype(np.float32) @ base)
        fast = fd.update_stream(fd.init(16, 128), jnp.asarray(a), mode="subspace")
        err = float(fd.covariance_error(jnp.asarray(a), fast.sketch))
        scale = float(np.linalg.norm(a.T @ a, 2))
        assert err <= 5e-2 * scale

    def test_honest_error_bound_on_duplicate_heavy_stream(self, rng):
        """VERDICT r1 weak #2: subspace-mode error_bound must upper-bound the
        measured covariance error on adversarial (duplicate-heavy,
        tie-degenerate) streams — shrink_fast now reports its exact trace
        residual instead of delta=0."""
        # duplicate-heavy: distinct rows each repeated many times (tied
        # eigenvalue clusters in every Gram), more distinct directions than
        # ell so every shrink genuinely loses mass
        distinct = rng.normal(size=(40, 96)).astype(np.float32)
        idx = rng.integers(0, 40, size=600)
        a = distinct[idx] + 0.01 * rng.normal(size=(600, 96)).astype(np.float32)
        st = fd.update_stream(fd.init(16, 96), jnp.asarray(a), mode="subspace")
        err = float(fd.covariance_error(jnp.asarray(a), st.sketch))
        scale = float(np.linalg.norm(a.T @ a, 2))
        # 1e-5*scale absorbs fp32 Gram/eigh measurement noise
        assert err <= float(fd.error_bound(st)) * 1.01 + 1e-5 * scale
        assert float(st.shrink_loss) > 0.0   # truncation reports its loss

    def test_honest_error_bound_gaussian(self, rng):
        a = rng.normal(size=(400, 64)).astype(np.float32)
        st = fd.update_stream(fd.init(16, 64), jnp.asarray(a), mode="subspace")
        err = float(fd.covariance_error(jnp.asarray(a), st.sketch))
        assert err <= float(fd.error_bound(st)) * 1.01

    def test_health_gate_routes_by_spectrum(self, rng):
        """The subspace health gate's ROUTING, asserted directly (a prior
        version asserted only end error, which the fallback satisfies too —
        the gate's second tier was dead and shipped green, review r5):
        clean full-rank stacks take the matmul-only branch; tie-degenerate
        and rank-deficient stacks take the eigh fallback — measured, the
        rescaled fast truncation is a QUALITY regression there (spectral
        error 565 vs eigh 237 on ties, 9492 vs 0 on rank-deficient at
        (64, 128)/ell=16)."""
        gauss = rng.normal(size=(64, 128)).astype(np.float32)
        base = rng.normal(size=(24, 128)).astype(np.float32)
        ties = np.concatenate([base, base, base[:16]])
        rankdef = (rng.normal(size=(64, 8)).astype(np.float32)
                   @ rng.normal(size=(8, 128)).astype(np.float32))
        for a, want in ((gauss, True), (ties, False), (rankdef, False)):
            healthy, _ = fd._subspace_basis(jnp.asarray(a), 16,
                                            oversample=16, sub_iters=4)
            assert bool(healthy) == want, (want, a.shape)

    def test_tie_degenerate_quality(self, rng):
        """Duplicate-heavy streams in subspace mode keep eigh-level quality
        (the gate routes them to the exact fallback) and honest loss."""
        distinct = rng.normal(size=(24, 128)).astype(np.float32) * 3.0
        idx = rng.integers(0, 24, size=512)
        a = distinct[idx] + 0.05 * rng.normal(size=(512, 128)).astype(np.float32)
        fast = fd.update_stream(fd.init(16, 128), jnp.asarray(a),
                                mode="subspace")
        exact = fd.update_stream(fd.init(16, 128), jnp.asarray(a))
        e_fast = float(fd.covariance_error(jnp.asarray(a), fast.sketch))
        e_exact = float(fd.covariance_error(jnp.asarray(a), exact.sketch))
        scale = float(np.linalg.norm(a.T @ a, 2))
        assert e_fast <= max(2.0 * e_exact, 0.05 * scale)

    def test_subspace_mode_bf16_state(self, rng):
        """Non-f32 sketch dtypes must trace in subspace mode (the fast
        branch previously returned f32 against the fallback's cast output
        — a lax.cond branch-type error, review r5)."""
        a = rng.normal(size=(128, 64)).astype(np.float32)
        st = fd.update_stream(fd.init(16, 64, jnp.bfloat16),
                              jnp.asarray(a, jnp.bfloat16), mode="subspace")
        assert st.sketch.dtype == jnp.bfloat16


class TestShrinkRR:
    """Rayleigh-Ritz shrink (fd.shrink_rr) — the huge-d fold shrink."""

    def test_never_overestimates(self, rng):
        s = rng.normal(size=(300, 500)).astype(np.float32)
        b, delta = fd.shrink_rr(jnp.asarray(s), 32)
        resid = s.T @ s - np.asarray(b).T @ np.asarray(b)
        lam = np.linalg.eigvalsh(resid)
        assert lam.min() >= -1e-2 * np.abs(lam).max()   # PSD up to fp noise
        # honest delta: exact trace of the residual
        np.testing.assert_allclose(float(delta), np.trace(resid),
                                   rtol=1e-3, atol=1.0)

    def test_stream_error_bound_holds(self, rng):
        n, ell = 512, 24
        a = (rng.random((n, n)) < 0.05).astype(np.float32)
        st = fd.update_stream(fd.init(ell, n), jnp.asarray(a), mode="rr")
        err = float(fd.covariance_error(jnp.asarray(a), st.sketch))
        assert err <= float(fd.error_bound(st)) + 1e-3

    @pytest.mark.slow
    def test_beats_or_matches_subspace_on_adjacency_fold(self, rng):
        """The huge-window fold regime: big absorb blocks + exact
        orthonormalization should match or beat the NS subspace shrink."""
        n, ell = 1024, 32
        labels = rng.integers(0, 5, n)
        a = ((labels[:, None] == labels[None, :])
             & (rng.random((n, n)) < 0.15)).astype(np.float32)
        e = {}
        for mode in ("rr", "subspace"):
            st = fd.update_stream(fd.init(ell, n), jnp.asarray(a), mode=mode)
            e[mode] = float(fd.covariance_error(jnp.asarray(a), st.sketch))
        assert e["rr"] <= 1.5 * e["subspace"]

    def test_small_stack_passthrough(self, rng):
        s = rng.normal(size=(16, 64)).astype(np.float32)
        b, delta = fd.shrink_rr(jnp.asarray(s), 32)
        np.testing.assert_array_equal(np.asarray(b), s)
        assert float(delta) == 0.0


def test_shrink_rr_decaying_spectrum(rng):
    """Power iterations without intermediate orthonormalization collapse the
    trailing subspace on decaying spectra ((lam_i/lam_1)^4 < f32 eps);
    between-iteration whitening must keep rr within ~2x of the exact eigh
    shrink there."""
    m, d, ell = 192, 400, 32
    u, _ = np.linalg.qr(rng.normal(size=(m, m)))
    v, _ = np.linalg.qr(rng.normal(size=(d, m)))
    s = (100.0 ** (-np.arange(m) / m)).astype(np.float32)   # decade decay
    stack = (u * s[None, :]) @ v.T
    b_rr, _ = fd.shrink_rr(jnp.asarray(stack, jnp.float32), ell)
    b_e, _ = fd.shrink(jnp.asarray(stack, jnp.float32), ell)
    def err(b):
        return np.linalg.norm(stack.T @ stack
                              - np.asarray(b).T @ np.asarray(b), ord=2)
    assert err(b_rr) <= 2.0 * err(b_e) + 1e-3


class TestShrinkRRPair:
    """Split-operand rr absorb (fd.shrink_rr_pair) — the bf16 huge-window
    fold path (rows never concatenated onto the f32 sketch)."""

    def test_matches_concat_rr(self, rng):
        """Pair form == shrink_rr on the explicit concat, up to f32
        summation order (the only difference by construction)."""
        sk = rng.normal(size=(64, 500)).astype(np.float32)
        rows = rng.normal(size=(192, 500)).astype(np.float32)
        b_pair, d_pair = fd.shrink_rr_pair(jnp.asarray(sk), jnp.asarray(rows), 64)
        b_cat, d_cat = fd.shrink_rr(jnp.asarray(np.vstack([sk, rows])), 64)
        np.testing.assert_allclose(
            np.asarray(b_pair).T @ np.asarray(b_pair),
            np.asarray(b_cat).T @ np.asarray(b_cat), rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(float(d_pair), float(d_cat),
                                   rtol=1e-3, atol=1e-2)

    def test_bf16_01_rows_exact(self, rng):
        """0/1 adjacency rows are bf16-exact: the bf16 fold must match the
        f32 fold at covariance level (operand dtype is the only change)."""
        rows01 = (rng.random(size=(192, 500)) < 0.05).astype(np.float32)
        sk = rng.normal(size=(64, 500)).astype(np.float32)
        b16, d16 = fd.shrink_rr_pair(jnp.asarray(sk),
                                     jnp.asarray(rows01, jnp.bfloat16), 64)
        b32, d32 = fd.shrink_rr_pair(jnp.asarray(sk), jnp.asarray(rows01), 64)
        np.testing.assert_allclose(
            np.asarray(b16).T @ np.asarray(b16),
            np.asarray(b32).T @ np.asarray(b32), rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(float(d16), float(d32), rtol=1e-3, atol=1e-2)

    def test_update_stream_rr_bf16_bound_holds(self, rng):
        """End-to-end: bf16 0/1 rows through update_stream(mode='rr') keep
        the honest error bound AND the bookkeeping (sq_frobenius exact)."""
        a = (rng.random(size=(600, 300)) < 0.08).astype(np.float32)
        st = fd.update_stream(fd.init(32, 300),
                              jnp.asarray(a, jnp.bfloat16), mode="rr")
        true_err = float(fd.covariance_error(jnp.asarray(a), st.sketch))
        assert float(fd.error_bound(st)) >= true_err - 1e-2
        np.testing.assert_allclose(float(st.sq_frobenius),
                                   float(np.sum(a * a)), rtol=1e-6)
        assert int(st.count) == 600


class TestRRStability:
    """Regression: the rr orthonormalization must be unconditionally stable.

    The original eigh-whiten Q = V (V^T V)^{-1/2} has condition ~kappa(G)^2
    and broke Q^T Q <= I once the sketch's spectral spread passed f32's
    floor — on the real 100k-window fold the sketch energy compounded
    exponentially after ~16 absorbs while the trace-residual loss froze at 0.
    Householder QR fixed it.  This distills the
    mechanism to CPU scale: a steep-spectrum stream (singular values
    spanning ~1e7) absorbed in 48 sequential shrink_rr_pair steps — the
    whiten violates the per-absorb bound ||B'||_F^2 <= ||S||_F^2 at ~3e-4
    relative, QR holds it at rounding (~4e-7 measured)."""

    def test_sequential_absorbs_respect_frobenius_bound(self, rng):
        d, ell, block, k_ev = 2048, 32, 256, 12
        basis = rng.standard_normal((k_ev, d)).astype(np.float32)
        basis /= np.linalg.norm(basis, axis=1, keepdims=True)
        scales = (10.0 ** np.linspace(4, -3, k_ev)).astype(np.float32)
        s = jnp.zeros((ell, d), jnp.float32)
        worst = 0.0
        for _ in range(48):
            w = (rng.random((block, k_ev)) < 0.4) * rng.random((block, k_ev))
            rows = (w * scales).astype(np.float32) @ basis
            rows += 0.01 * (rng.random((block, d)) < 0.02)
            rows = jnp.asarray(rows, jnp.bfloat16)
            sq = float(jnp.sum(s * s)
                       + jnp.sum(jnp.square(rows.astype(jnp.float32))))
            s, _ = fd.shrink_rr_pair(s, rows, ell)
            worst = max(worst, (float(jnp.sum(s * s)) - sq) / sq)
        assert worst <= 1e-5, f"rr absorb bound overshoot {worst:.3g}"
