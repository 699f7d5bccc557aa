"""The port's LPIPS-vgg (``svgir_tpu_torch.eval.lpips``, ``nn.Conv2d``
layers, no torchvision) against svgir_tpu's ``LPIPSJax`` on random weights
written as the ``.npz`` that ``tools/convert_lpips_weights.py`` makes: the
distance within 2e-5 relative, 0 on identical images, and the metric's
weights resolution (argument, then ``$SVGIR_LPIPS_WEIGHTS``)."""

import os

import numpy as np
import pytest
import torch

from svgir_tpu.eval.lpips_jax import LPIPSJax
from svgir_tpu.eval.lpips_jax import required_keys as j_required_keys

from svgir_tpu_torch.eval import metrics as TM
from svgir_tpu_torch.eval.lpips import LPIPS, required_keys

from test_lpips import random_weights


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops.  Under the parallel test run the CPU is
    oversubscribed, and an op split over torch's thread pool waits for
    descheduled threads (a stage-2 loop took 42 s on 8 threads against 6 s
    on one beside six busy processes); one thread for the module, its
    module-scoped fixtures included."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz")
    np.savez(path, **random_weights(seed=5))
    return path


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 3, 48, 80)],
                         ids=["image", "batch"])
def test_lpips_matches_jax(weights_file, shape):
    rng = np.random.default_rng(1)
    x = rng.random(shape).astype(np.float32)
    y = rng.random(shape).astype(np.float32)
    want = np.asarray(LPIPSJax.from_npz(weights_file)(x, y))
    got = LPIPS.from_npz(weights_file, device="cpu")(torch.as_tensor(x),
                                                     torch.as_tensor(y))
    assert got.shape == want.shape == (shape[0] if len(shape) == 4 else 1,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)


def test_lpips_zero_on_identical_images(weights_file):
    net = LPIPS.from_npz(weights_file, device="cpu")
    x = torch.as_tensor(np.random.default_rng(2).random((3, 32, 32))
                        .astype(np.float32))
    assert abs(float(net(x, x)[0])) < 1e-7
    assert float(net(x, torch.clamp(x + 0.3, 0, 1))[0]) > 1e-4
    assert required_keys() == j_required_keys()
    with pytest.raises(ValueError, match="missing keys"):
        LPIPS({k: v for k, v in random_weights().items() if k != "lin4"})


def test_metrics_lpips_resolves_the_weights(weights_file, tmp_path,
                                            monkeypatch):
    rng = np.random.default_rng(3)
    x = rng.random((3, 32, 32)).astype(np.float32)
    y = rng.random((3, 32, 32)).astype(np.float32)
    want = float(LPIPSJax.from_npz(weights_file)(x, y)[0])
    assert abs(TM.lpips(torch.as_tensor(x), y, weights_file) - want) \
        <= 2e-5 * want
    missing = os.path.join(tmp_path, "nope.npz")
    assert TM.lpips(x, y, missing) is None
    monkeypatch.setenv("SVGIR_LPIPS_WEIGHTS", weights_file)
    assert TM.lpips_weights_path() == weights_file
    assert TM.lpips_status() == (True, None)
    assert abs(TM.lpips(torch.as_tensor(x), y) - want) <= 2e-5 * want
