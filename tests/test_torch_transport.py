"""PyTorch port, the transport and the data path held against the JAX
package on the CPU:

- each path's ``interpolate`` (and alpha, sigma, drift) on the same numpy
  inputs;
- ``Transport.training_losses`` for the velocity, noise and score
  objectives with a fixed ``model_fn`` on both sides: the JAX function
  draws t and x0 from its key, and the port is handed those same draws;
- ``check_interval``;
- ``synthesize_trajectory`` (same numpy random walk, the port's own
  geometry) and ``MDGenDataset`` batches drawn with the same numpy seed.

Tolerances: rtol 1e-5 / atol 1e-6 (f32 elementwise math in other orders);
atom14 coordinates agree to 1.6e-2 Angstrom, two float16 steps at ~10
Angstrom.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.config import MDGenConfig, TransportConfig
from mdgen_finetune_tpu.config import DataConfig as JDataConfig
from mdgen_finetune_tpu.data.dataset import MDGenDataset as JDataset
from mdgen_finetune_tpu.data.synthetic import synthesize_trajectory as j_synth
from mdgen_finetune_tpu.transport import create_transport as j_create_transport
from mdgen_finetune_tpu.transport.paths import get_path as j_get_path
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.data.dataset import MDGenDataset
from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset, synthesize_trajectory
from mdgen_finetune_tpu_torch.transport import check_interval, create_transport, get_path

RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["Linear", "GVP", "VP"])
def test_paths_match_jax(name):
    rng = np.random.default_rng(0)
    t = rng.uniform(0.05, 0.95, size=(3, 1, 1)).astype(np.float32)
    x0, x1 = (rng.normal(size=(3, 4, 5)).astype(np.float32) for _ in range(2))
    tp, jp = get_path(name), j_get_path(name)
    for got, ref in zip(tp.interpolate(*map(torch.from_numpy, (t, x0, x1))),
                        jp.interpolate(*map(jnp.asarray, (t, x0, x1)))):
        _close(got, ref)
    for fn in ("alpha", "sigma"):
        for got, ref in zip(getattr(tp, fn)(torch.from_numpy(t)), getattr(jp, fn)(jnp.asarray(t))):
            _close(got, ref)
    for got, ref in zip(tp.drift(torch.from_numpy(x1), torch.from_numpy(t)),
                        jp.drift(jnp.asarray(x1), jnp.asarray(t))):
        _close(got, ref)


@pytest.mark.parametrize("transport", [
    dict(), dict(path_type="Linear"), dict(path_type="VP"),
    dict(prediction="noise", loss_weight="velocity"),
    dict(prediction="score", loss_weight="likelihood"),
    dict(prediction="noise", loss_weight="none"),
])
def test_training_losses_match_jax(transport):
    cfg = MDGenConfig(transport=TransportConfig(**transport))
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    rng = np.random.default_rng(1)
    x1 = rng.normal(size=(3, 4, 2, 5)).astype(np.float32)
    mask = (rng.uniform(size=x1.shape) > 0.3).astype(np.float32)
    key = jax.random.key(7)
    jt = j_create_transport(cfg)
    ref = jt.training_losses(lambda x, t: 0.5 * x + t[:, None, None, None], key, jnp.asarray(x1),
                             mask=jnp.asarray(mask))
    # the draws of the JAX function (transport.py:83-88), handed to the port
    k_t, k_x0, _ = jax.random.split(key, 3)
    x0 = np.asarray(jax.random.normal(k_x0, x1.shape))
    t0, t1 = jt.check_interval()
    t = np.asarray(jax.random.uniform(k_t, (3,)) * (t1 - t0) + t0)
    got = create_transport(tc).training_losses(
        lambda x, tt: 0.5 * x + tt[:, None, None, None], torch.from_numpy(x1),
        mask=torch.from_numpy(mask), t=torch.from_numpy(t), x0=torch.from_numpy(x0))
    _close(got["t"], ref["t"])
    _close(got["pred"], ref["pred"])
    _close(got["loss"], ref["loss"])


@pytest.mark.parametrize("transport", [dict(), dict(path_type="VP"), dict(prediction="noise")])
def test_check_interval_matches_jax(transport):
    cfg = MDGenConfig(transport=TransportConfig(**transport))
    tc = tcfg.MDGenConfig.from_json(cfg.to_json())
    jt = j_create_transport(cfg)
    for kw in (dict(), dict(eval=True), dict(sde=True, eval=True, last_step_size=0.04)):
        assert check_interval(tc, **kw) == pytest.approx(jt.check_interval(**kw))


def test_training_losses_draw_from_the_generator():
    tc = tcfg.MDGenConfig()
    x1 = torch.randn(4, 3, 2, 5, generator=torch.Generator().manual_seed(0))
    tr = create_transport(tc)

    def run(seed):
        return tr.training_losses(lambda x, t: x, x1, generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a["loss"], b["loss"]) and not torch.equal(a["loss"], c["loss"])
    assert ((a["t"] >= 0) & (a["t"] < 1)).all()


def test_synthetic_data_and_dataset_match_jax(tmp_path):
    ref = j_synth("GHKL", 12, seed=3).astype(np.float32)
    got = synthesize_trajectory("GHKL", 12, seed=3).astype(np.float32)
    assert got.dtype == np.float32 and got.shape == (12, 4, 14, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.6e-2)

    split = make_synthetic_dataset(str(tmp_path), ["AAGG", "GHKL"], num_frames=20)
    tc = tcfg.MDGenConfig(data=tcfg.DataConfig(data_dir=str(tmp_path), num_frames=8, crop=4))
    jc = MDGenConfig(data=JDataConfig(data_dir=str(tmp_path), num_frames=8, crop=4))
    b = MDGenDataset(tc, split).batch(np.random.default_rng(5), 3)
    jb = JDataset(jc, split).batch(np.random.default_rng(5), 3)
    assert b["name"] == jb["name"]
    for k in ("atom14", "seqres", "mask"):
        np.testing.assert_array_equal(b[k], jb[k])
    with pytest.raises(FileNotFoundError):
        MDGenDataset(tc, split, data_dir=str(tmp_path / "missing"))
