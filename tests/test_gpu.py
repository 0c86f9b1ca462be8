"""Checks that only the card can answer: what XLA's GPU backend makes of the
operations the engine relies on, each against the same operation on the host
CPU.  Marked ``gpu``: they skip on a host without a GPU and run in
``python chip_smoke.py`` (or ``JAX_PLATFORMS=cuda,cpu pytest -m gpu``)."""
import numpy as np
import pytest
import jax

pytestmark = pytest.mark.gpu


@pytest.fixture
def devices():
    """(gpu, cpu) devices; skips unless JAX's first device is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (first jax device is {dev.platform!r})")
    return dev, jax.devices("cpu")[0]


def _on(device, fn, *args):
    with jax.default_device(device):
        return jax.tree.map(np.asarray, fn(*jax.device_put(args, device)))


@pytest.mark.parametrize("shape", [(512, 2048, 4096), (333, 2048, 1001)])
def test_int8_count_dot_is_exact(devices, shape):
    """The tags Jaccard intersection: an int8 x int8 dot accumulated in
    int32 (blocked_affinity._count_dot).  Counts are small integers, so the
    GPU result must equal the CPU's exactly, odd shapes included."""
    from mused_tpu.ops.blocked_affinity import _count_dot
    m, k, n = shape
    rng = np.random.default_rng(0)
    a = (rng.random((m, k)) < 0.01).astype(np.int8) * rng.integers(
        1, 4, (m, k), dtype=np.int8)
    b = (rng.random((n, k)) < 0.01).astype(np.int8)
    gpu, cpu = devices
    got = _on(gpu, jax.jit(_count_dot), a, b)
    want = _on(cpu, jax.jit(_count_dot), a, b)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [50, 150])
def test_top_k_matches_cpu(devices, k):
    """lax.top_k at the flagship's widths (k=150 is the time modality's
    3*k_basis over 2000 columns): distinct values give identical indices."""
    rng = np.random.default_rng(1)
    x = rng.permutation(2000 * 2000).reshape(2000, 2000).astype(np.float32)
    gpu, cpu = devices
    f = jax.jit(lambda v: jax.lax.top_k(v, k))
    (vg, ig), (vc, ic) = _on(gpu, f, x), _on(cpu, f, x)
    np.testing.assert_array_equal(vg, vc)
    np.testing.assert_array_equal(ig, ic)


def test_device_hdbscan_matches_host(devices):
    """Above the dense-Prim cap HDBSCAN runs the device Boruvka on the GPU
    (platform_paths().device_hdbscan): same MST, same labels as host Prim."""
    from mused_tpu.ops import dbscan
    from mused_tpu.ops.blocked_hdbscan import hdbscan_blocked
    from mused_tpu.utils.metrics import nmi
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(6, 4)) * 10
    x = (centers[rng.integers(0, 6, 20_000)]
         + rng.normal(size=(20_000, 4))).astype(np.float32)
    want = dbscan.hdbscan(x[:4000], min_cluster_size=5, min_samples=3)
    got = hdbscan_blocked(x[:4000], min_cluster_size=5, min_samples=3)
    assert nmi(want, np.asarray(got)) > 0.999
    labels = dbscan.hdbscan(x, min_cluster_size=5, min_samples=3)
    assert labels.shape == (20_000,) and labels.max() >= 1
