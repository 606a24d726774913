"""The port's eigen-analysis against tlie_tpu's on carried weights.

Trained spectra are a function of the parameters only, so they must agree
pointwise (1e-6: both compute λ in float32 from the same ν, θ); the
percentages and the artifact file set must be equal.  Init spectra come from
each package's own seeded init and cannot match draw for draw: they are held
to their distribution instead (|λ| on the [r_min, r_max] ring, phase in
[0, max_phase]).
"""

import os
import sys

import numpy as np
import pytest
import torch

from tlie_tpu.analysis.binning import PHASE_THRESHOLDS as JAX_PHASE_T
from tlie_tpu.analysis.binning import RADIUS_THRESHOLDS as JAX_RADIUS_T
from tlie_tpu.analysis.binning import threshold_analysis_ssm as jax_threshold
from tlie_tpu.analysis.eval_eig import _extract_ssm_family, _ssm_layer_params
from tlie_tpu.analysis.eval_eig import eval_eig as jax_eval_eig
from tlie_tpu_torch.analysis import (
    PHASE_THRESHOLDS, RADIUS_THRESHOLDS, eval_eig, threshold_analysis_ssm,
)
from tlie_tpu_torch.analysis.eval_eig import extract_ssm_family, ssm_layer_params
from tlie_tpu_torch.compat import params_from_jax
from torch_parity import jax_weights, small_config

torch.set_num_threads(1)
PERF = 0.5


@pytest.fixture(scope="module")
def carried():
    cfg = small_config()
    _, params, stats = jax_weights(cfg["model"], seed=4)
    return cfg, params, stats, params_from_jax(params, stats)


@pytest.fixture(scope="module")
def both_runs(carried, tmp_path_factory):
    cfg, params, _, sd = carried
    jax_dir, port_dir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    want = jax_eval_eig(cfg, {"save_path": str(jax_dir)}, None, cfg["dataset"], None,
                        "unused", PERF, params=params)
    got = eval_eig(cfg, {"save_path": str(port_dir)}, PERF, sd, device="cpu")
    return cfg, want, got, jax_dir, port_dir


def test_trained_eig_matches_jax(carried):
    cfg, params, _, sd = carried
    want = _extract_ssm_family(_ssm_layer_params(params), cfg["model"])
    got = extract_ssm_family(ssm_layer_params(sd), cfg["model"])
    assert got.dtype == want.dtype
    assert got.shape == want.shape == (cfg["model"]["state_dim"], cfg["model"]["num_layers"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_eval_eig_trained_outputs_match_jax(both_runs):
    _, want, got, _, _ = both_runs
    eig, _, perc, _, perc_phase, _ = got
    np.testing.assert_allclose(eig, want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(perc, want[2])
    np.testing.assert_array_equal(perc_phase, want[4])


def test_eval_eig_writes_the_same_artifact_set(both_runs):
    _, _, _, jax_dir, port_dir = both_runs
    (jax_run,), (port_run,) = os.listdir(jax_dir), os.listdir(port_dir)
    assert port_run == jax_run
    assert sorted(os.listdir(port_dir / port_run)) == sorted(os.listdir(jax_dir / jax_run))
    for name in ("eig.npy", "percentage.npy", "percentage_phase.npy", "percentage_mean.npy"):
        np.testing.assert_allclose(np.load(port_dir / port_run / name),
                                   np.load(jax_dir / jax_run / name), rtol=0, atol=1e-6)
    cfg_port = (port_dir / port_run / "used_config.yaml").read_text()
    assert cfg_port == (jax_dir / jax_run / "used_config.yaml").read_text()


def test_init_spectra_follow_the_ring(both_runs):
    cfg, want, got, _, _ = both_runs
    m = cfg["model"]
    for eig_init in (got[1], want[1]):
        r = np.abs(eig_init)
        phase = np.mod(np.angle(eig_init), 2 * np.pi)
        assert eig_init.shape == (m["state_dim"], m["num_layers"])
        assert r.min() >= m["r_min"] - 1e-6 and r.max() <= m["r_max"] + 1e-6
        assert phase.max() <= m.get("max_phase", 6.28) + 1e-5
    # radius bins agree (all on the ring); the init draws themselves differ
    np.testing.assert_array_equal(got[3], want[3])
    assert not np.allclose(got[1], want[1])


def test_thresholds_and_binning_match_jax():
    np.testing.assert_array_equal(RADIUS_THRESHOLDS, JAX_RADIUS_T)
    np.testing.assert_array_equal(PHASE_THRESHOLDS, JAX_PHASE_T)
    rng = np.random.default_rng(0)
    vals = rng.uniform(-5, 200, (64, 3))
    vals[:7, 0] = [0.1, 0.5, 0.9, 1.0, 10, 100, 0.0]  # boundaries count in two bins
    for t in (RADIUS_THRESHOLDS, PHASE_THRESHOLDS):
        np.testing.assert_array_equal(threshold_analysis_ssm(vals, t), jax_threshold(vals, t))


def test_eval_eig_needs_a_save_path(carried):
    cfg, _, _, sd = carried
    with pytest.raises(ValueError, match="save_path"):
        eval_eig(cfg, {}, PERF, sd, device="cpu")


def test_used_config_left_out_without_yaml(carried, tmp_path, monkeypatch):
    cfg, _, _, sd = carried
    monkeypatch.setitem(sys.modules, "yaml", None)
    eval_eig(cfg, {"save_path": str(tmp_path)}, PERF, sd, device="cpu")
    (run,) = os.listdir(tmp_path)
    files = os.listdir(tmp_path / run)
    assert "used_config.yaml" not in files and len(files) == 11


def test_layers_are_taken_in_numeric_order():
    """Deviation: tlie_tpu sorts layer keys as strings (layers_10 before
    layers_2); the port takes spectra columns in layer order."""
    sd = {f"encoder.layers.{i}.seq.nu_log": torch.full((2,), float(i)) for i in (10, 2, 0, 1)}
    assert [float(lp["nu_log"][0]) for lp in ssm_layer_params(sd)] == [0.0, 1.0, 2.0, 10.0]
