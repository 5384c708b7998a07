"""The CUDA kernels K1 and K2 against their plain versions, on the card.

These tests need a CUDA GPU (and the CUDA toolkit, to build the kernels);
they skip without one.  On a machine with the card, run them without the
repository's JAX conftests:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

The kernels compute in f64 with another summation order (and fused
multiply-adds) than the plain versions; they agree to 1e-12 of scale.
"""

import numpy as np
import pytest
import torch

from pyimcom_tpu_torch.ops import interp, interp_cuda

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu
TOL = 1e-12


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_k1_matches_plain_and_counts_launches(cuda):
    rng = np.random.default_rng(0)
    R, Nq, ns = 5, 3000, 91                    # no (8, 128) alignment needed
    images = torch.as_tensor(rng.normal(size=(R, ns, ns)), device=cuda)
    x = torch.as_tensor(rng.uniform(-4, ns + 4, (R, Nq)), device=cuda)
    y = torch.as_tensor(rng.uniform(-4, ns + 4, (R, Nq)), device=cuda)
    interp_cuda.reset_launch_counts()
    got = interp.interp2d_dense(images, x, y)
    assert interp_cuda.launches["interp_d5512_dense"] == 1
    want = interp_cuda.interp_d5512_dense_plain(images, x, y)
    assert interp_cuda.launches["interp_d5512_dense"] == 1
    assert _rel(got, want) < TOL
    assert torch.equal(got == 0, want == 0)


@pytest.mark.parametrize("mode", [0, 1], ids=["pool", "B"])
def test_k2_matches_plain(cuda, mode):
    rng = np.random.default_rng(1 + mode)
    K, ns, L, rows, bucket = 4, 75, 500, 6, 1024
    m, n_pad = 37, 200
    combined = torch.as_tensor(rng.normal(size=(K, ns, ns)), device=cuda)
    xt = torch.as_tensor(rng.uniform(0, 20, L), device=cuda)
    yt = torch.as_tensor(rng.uniform(0, 20, L), device=cuda)
    ks = rng.integers(0, K, rows)
    w2 = np.full(rows, m) if mode else rng.integers(5, 60, rows)
    nval = rng.integers(bucket // 2, bucket + 1, rows)
    nval[-1] = 0                                # a padded row
    off = rng.integers(0, 50, rows)
    imeta = np.stack([rng.integers(0, 100, rows), rng.integers(0, 100, rows),
                      w2, off, nval], 1)
    if mode == 0:
        base = np.arange(rows) * 4 * bucket
        dmeta = np.stack([base, w2, w2 + 3, off, nval], 1)
        size = rows * 4 * bucket
    else:
        dmeta = np.stack([np.zeros(rows, int), np.arange(rows) * 30, off, nval], 1)
        size = m * n_pad

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=cuda)

    args = (combined, xt, yt, put(ks), put(imeta), put(dmeta), 1.7, 37.0, bucket,
            mode, n_pad, m)
    got = interp_cuda.sweep_d5512_scatter(
        torch.zeros(size, dtype=torch.float64, device=cuda), *args)
    want = interp_cuda.sweep_d5512_scatter_plain(
        torch.zeros(size, dtype=torch.float64, device=cuda), *args)
    assert int((want != 0).sum()) > rows * bucket // 4
    assert _rel(got, want) < TOL


def test_wrappers_reject_bad_inputs_on_the_card(cuda):
    images = torch.zeros((2, 20, 20), dtype=torch.float32, device=cuda)
    q = torch.zeros((2, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        interp_cuda.interp_d5512_dense(images, q, q)
    with pytest.raises(ValueError):
        interp_cuda.interp_d5512_dense(images.double(), q.T.contiguous(), q.T.contiguous())
