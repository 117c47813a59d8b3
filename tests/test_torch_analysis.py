"""The port's analysis stack (what the task CLIs' MSM metadata needs) on the
CPU against the JAX package's, on one 300-frame synthetic "AGHK"
trajectory: ``featurize_trajectory`` (the port's torsions against JAX's
jitted geometry), ``TICA``, ``KMeans``, ``MarkovStateModel`` with PCCA+,
and ``cli.msm_common``'s ``build_msm_metadata`` / ``pick_flux_states``, each
stage of the port fed by the port's previous stage and JAX's by JAX's.

Tolerances: features rtol 1e-5 / atol 1e-5 (cos / sin values, f32
geometry); TICA projections, transition matrices and stationary
distributions rtol 1e-5 / atol 1e-8 (the projections atol 1e-5 of their
largest magnitude: the features' f32 rounding passes through the
whitening); cluster and metastable assignments and
the flux states equal.
"""
import numpy as np
import pytest

from mdgen_finetune_tpu import analysis as ja
from mdgen_finetune_tpu.cli import msm_common as jmsm
from mdgen_finetune_tpu.geometry.tables import str_sequence_to_aatype
from mdgen_finetune_tpu_torch import analysis as ta
from mdgen_finetune_tpu_torch.cli import msm_common as tmsm
from mdgen_finetune_tpu_torch.data.synthetic import synthesize_trajectory

SEQ, FRAMES = "AGHK", 300
ARRAYS = dict(rtol=1e-5, atol=1e-8)


@pytest.fixture(scope="module")
def traj():
    atom14 = synthesize_trajectory(SEQ, FRAMES, seed=0).astype(np.float32)
    return atom14, str_sequence_to_aatype(SEQ)


@pytest.fixture(scope="module")
def stages(traj):
    """(port, JAX) results of each stage, the analysis of msm_common."""
    atom14, aatype = traj
    out = {}
    for name, pkg in (("torch", ta), ("jax", ja)):
        labels, feats = pkg.featurize_trajectory(atom14, aatype, sidechains=True, cossin=True)
        tica = pkg.TICA(lag=FRAMES // 4).fit(feats)
        proj = tica.transform(feats)
        km = pkg.KMeans(k=FRAMES // 20, seed=137).fit(proj)
        assign = km.transform(proj)
        msm = pkg.MarkovStateModel(lag=FRAMES // 4).fit(assign).pcca(10)
        out[name] = dict(labels=labels, feats=feats, tica=tica, proj=proj, km=km, assign=assign,
                         msm=msm)
    return out


def test_featurize_trajectory_matches_jax(traj, stages):
    t, j = stages["torch"], stages["jax"]
    # AGHK: phi 2-4, psi 1-3, His chi 1-2, Lys chi 1-4, each as (cos, sin)
    assert t["labels"] == j["labels"] and t["feats"].shape == j["feats"].shape == (FRAMES, 24)
    np.testing.assert_allclose(t["feats"], j["feats"], rtol=1e-5, atol=1e-5)
    atom14, aatype = traj
    assert ta.feature_labels(aatype) == ja.feature_labels(aatype)
    labels, angles = ta.featurize_trajectory(atom14, aatype, cossin=False)
    _, jangles = ja.featurize_trajectory(atom14, aatype, cossin=False)
    assert len(labels) == angles.shape[1] == 6  # phi 2-4, psi 1-3
    np.testing.assert_allclose(np.cos(angles), np.cos(jangles), rtol=1e-5, atol=1e-5)


def test_tica_and_kmeans_match_jax(stages):
    t, j = stages["torch"], stages["jax"]
    assert t["tica"].dim_ == j["tica"].dim_
    np.testing.assert_allclose(t["tica"].eigenvalues_, j["tica"].eigenvalues_, **ARRAYS)
    # eigenvectors up to sign: compare the kinetic-map projections column by column
    sign = np.sign(np.sum(t["proj"] * j["proj"], axis=0))
    scale = np.abs(j["proj"]).max()
    np.testing.assert_allclose(t["proj"] * sign, j["proj"], rtol=1e-5, atol=1e-5 * scale)
    # the same projection clustered by both copies gives the same centers
    np.testing.assert_array_equal(ta.KMeans(k=15, seed=137).fit(j["proj"]).transform(j["proj"]),
                                  j["assign"])
    np.testing.assert_array_equal(t["assign"], ja.KMeans(k=15, seed=137).fit(
        t["proj"]).transform(t["proj"]))
    np.testing.assert_array_equal(t["assign"], j["assign"])


def test_markov_state_model_matches_jax(stages):
    t, j = stages["torch"]["msm"], stages["jax"]["msm"]
    msm = ta.MarkovStateModel(lag=FRAMES // 4).fit(stages["jax"]["assign"]).pcca(10)
    np.testing.assert_array_equal(msm.active_set, j.active_set)
    np.testing.assert_allclose(msm.transition_matrix, j.transition_matrix, **ARRAYS)
    np.testing.assert_allclose(msm.pi, j.pi, **ARRAYS)
    np.testing.assert_allclose(msm.memberships, j.memberships, rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(msm.metastable_assignments, j.metastable_assignments)
    np.testing.assert_allclose(ta.pcca_plus(j.transition_matrix, j.pi, 4),
                               ja.pcca_plus(j.transition_matrix, j.pi, 4), **ARRAYS)
    np.testing.assert_allclose(t.transition_matrix, j.transition_matrix, **ARRAYS)
    np.testing.assert_array_equal(t.metastable_assignments, j.metastable_assignments)


def test_msm_metadata_and_flux_states_match_jax(tmp_path, traj):
    atom14, aatype = traj
    npy = tmp_path / f"{SEQ}.npy"
    np.save(npy, atom14.astype(np.float16))
    t = tmsm.build_msm_metadata(str(npy), aatype, str(tmp_path / "t.pkl"))
    j = jmsm.build_msm_metadata(str(npy), aatype, str(tmp_path / "j.pkl"))
    assert t is not None and j is not None
    np.testing.assert_array_equal(t["ref_kmeans"], j["ref_kmeans"])
    np.testing.assert_array_equal(t["msm"].metastable_assignments, j["msm"].metastable_assignments)
    np.testing.assert_allclose(t["cmsm"].transition_matrix, j["cmsm"].transition_matrix, **ARRAYS)
    for mode in ("min", "max"):
        assert tmsm.pick_flux_states(t["cmsm"], mode) == jmsm.pick_flux_states(j["cmsm"], mode)
    # the cache: a second call reads the pickle
    again = tmsm.build_msm_metadata(str(npy), aatype, str(tmp_path / "t.pkl"))
    np.testing.assert_array_equal(again["ref_kmeans"], t["ref_kmeans"])
