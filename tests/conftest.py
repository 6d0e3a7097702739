"""Test configuration.

Tests run on the CPU: this file forces ``jax_platforms=cpu`` with float64 enabled
(numerical parity against the reference GPy/GPyOpt stack, which is float64
numpy/LAPACK throughout) and 8 virtual CPU devices, so the multi-device sharding
programs run without GPUs. The platform goes through ``jax.config`` as well as the
environment, and the host-device-count flag is set before the CPU backend starts.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu`` fixture,
which skips them when JAX has no GPU backend. They run on a GPU machine with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``: a GPU platform named in
``JAX_PLATFORMS`` is left to JAX (and float64 off) instead of forcing the CPU.
"""
import os

ON_GPU = os.environ.get("JAX_PLATFORMS", "") in ("cuda", "gpu")
if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has no GPU backend."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; jax backend is {jax.default_backend()!r}")
    return jax.devices()[0]


@pytest.fixture
def rng():
    import numpy as np

    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running consistency tests (>= ~14 s each on a loaded "
        "host). Default local runs use -m 'not slow' (see CLAUDE.md); CI / "
        "judging runs the full suite.",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU (skips without one, decided in the `gpu` fixture); "
        "run with JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu",
    )


# Auto-marked slow tier, measured from a full-suite --durations run (round 3).
# Matched by 'file::function' so parametrized variants inherit the mark.
_SLOW = {
    "test_bo.py::test_bo_ask_tell",
    "test_bo_general.py::test_get_moments_and_d_moments",
    "test_bo_general.py::test_integrated_acquisition_delegates",
    "test_likelihood_quantiles.py::test_laplace_quantiles_and_samples",
    "test_bo.py::test_bo_cost_model_evaluation_time",
    "test_bo.py::test_bo_forrester_sequential_ei",
    "test_bo.py::test_bo_maximize",
    "test_bo.py::test_bo_mixed_space_gower_lp_batch",
    "test_bo.py::test_bo_random_and_thompson_batches",
    "test_bo.py::test_bo_reports",
    "test_bo.py::test_bo_with_constraints_and_context",
    "test_bo_fuzz.py::test_bo_gower_mixed_space_smoke",
    "test_bo_fuzz.py::test_bo_random_space_never_crashes",
    "test_classification.py::test_gp_classification_optimize_improves_evidence",
    "test_cluster.py::test_cluster_recovers_groups",
    "test_examples.py::test_latent_plots_and_clustering_example",
    "test_cluster.py::test_pair_likelihood_and_offset",
    "test_cluster.py::test_padded_batch_matches_model_class",
    "test_epmgp.py::test_es_mc_and_epmgp_rank_agreement",
    "test_epmgp.py::test_joint_min_derivatives_match_fd",
    "test_es_pool_serialization.py::test_bo_state_roundtrip",
    "test_es_pool_serialization.py::test_entropy_search_acquisition",
    "test_es_pool_serialization.py::test_pool_selection_lp",
    "test_examples.py::test_classification_and_latents_example",
    "test_examples.py::test_forrester_gp_example",
    "test_examples.py::test_latent_inference_example",
    "test_examples.py::test_mixed_design_example",
    "test_examples.py::test_multichip_bo_example",
    "test_gp.py::test_lml_gradient_checkgrad",
    "test_graft_entry.py::test_dryrun_multichip_8_as_driver",
    "test_grid_svgp_classif.py::test_grid_matches_dense",
    "test_grid_svgp_classif.py::test_svgp_classification",
    "test_ibp_lfm.py::test_elbo_gradients_finite_and_optimize_improves",
    "test_ibp_lfm.py::test_gamma_one_recovers_vardtc_bound",
    "test_ibp_lfm.py::test_single_force_selection",
    "test_inference_x.py::test_infer_newx_bgplvm_recovers_training_latents",
    "test_inference_x.py::test_infer_newx_gplvm_recovers_training_latents",
    "test_lfm.py::test_eq_ode1_large_nu_no_overflow",
    "test_lfm.py::test_lfm_gp_regression_smoke",
    "test_likelihoods_laplace.py::test_state_space_matches_dense",
    "test_lp_mcmc.py::test_lp_over_mcmc_acquisition",
    "test_lvmogp.py::test_lvmogp_fit_improves_and_predicts",
    "test_lvmogp.py::test_lvmogp_md_ragged_finite",
    "test_model_zoo_tail.py::test_bcgplvm_improves_lml",
    "test_model_zoo_tail.py::test_gp_offset_regression_recovers_offset",
    "test_model_zoo_tail.py::test_one_vs_all_classification",
    "test_model_zoo_tail.py::test_sparse_gplvm_improves_bound",
    "test_model_zoo_tail.py::test_var_gauss_model_facade",
    "test_models_extra.py::test_bo_with_mcmc_model",
    "test_models_extra.py::test_bo_with_rf_and_sparse",
    "test_models_extra.py::test_config_driver",
    "test_models_extra.py::test_gpmodel_mcmc",
    "test_models_extra.py::test_mcmc_acquisition_integrates",
    "test_models_extra.py::test_sparse_bo_model",
    "test_models_extra.py::test_warped_bo_models",
    "test_modular_plots.py::test_modular_bo",
    "test_modular_plots.py::test_plot_surfaces",
    "test_mrd.py::test_mrd_two_views_recover_shared_and_private",
    "test_multioutput_het.py::test_coregionalized_transfer",
    "test_optimizers_tp.py::test_bo_with_direct_and_cma",
    "test_parallel.py::test_bo_loop_on_mesh",
    "test_parallel.py::test_sharded_acq_argmax_matches_unsharded",
    "test_parallel.py::test_sharded_multistart_fit_matches_single_device",
    "test_sparse.py::test_sparse_fit_trains_Z_and_hypers",
    "test_sparse.py::test_svgp_elbo_below_exact_and_training_improves",
    "test_sparse_multioutput_models.py::test_md_optimize_improves",
    "test_sparse_multioutput_models.py::test_sparse_coreg_optimize_improves",
    "test_ss_gplvm.py::test_ssgplvm_fit_improves_elbo",
    "test_state_space_periodic.py::test_from_kernel_bridge_matches_dense",
    "test_state_space_periodic.py::test_periodic_matches_dense",
    "test_state_space_periodic.py::test_quasiperiodic_matches_dense",
    "test_state_space_periodic.py::test_sum_kernel_matches_dense",
    "test_state_space_sde_tail.py::test_brownian_plus_matern_sum_matches_dense",
    "test_state_space_sde_tail.py::test_rbf_spectral_gradients_finite",
    "test_state_space_sde_tail.py::test_rbf_spectral_matches_dense",
    "test_state_space_sde_tail.py::test_state_space_packs_and_fits",
    "test_var_gauss.py::test_vargauss_classification_matches_laplace",
}


def pytest_collection_modifyitems(config, items):
    import pytest as _pytest

    for item in items:
        base = item.nodeid.split("[")[0]
        base = base.split("/")[-1]
        if base in _SLOW:
            item.add_marker(_pytest.mark.slow)
