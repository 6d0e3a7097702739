"""The outer Bayesian-optimization loop (GPyOpt/GPyOpt/core/bo.py:21 `BO`).

Flow per iteration (bo.py:73-197): fit surrogate on normalized data (:236) -> stop
checks (max_iter / max_time / ||x_t - x_{t-1}|| <= eps, :207) -> acquisition argmax /
batch construction (:216) -> evaluate objective -> loop. Failure semantics preserved:
a failed fit (Cholesky failure even after the jitter ladder) *breaks* the loop rather
than crashing (bo.py:134-137).

The loop itself is host-side Python (the objective is an external system), but every
numeric step inside — fit, sweep, multistart, LP penalization — is a jitted device
program via the model wrapper / acquisition optimizer. Padded-bucket buffers keep
those programs compiled-once as N grows.
"""
from __future__ import annotations

import time

import numpy as np

from ..utils.normalizer import normalize_stats
from .duplicate_manager import DuplicateManager
from .optimizer import ContextManager


class BO:
    def __init__(
        self,
        model,
        space,
        objective,
        acquisition,
        evaluator,
        X_init,
        Y_init=None,
        cost=None,
        normalize_Y=True,
        model_update_interval=1,
        de_duplication=False,
        normalization_type="stats",
    ):
        self.model = model
        self.space = space
        self.objective = objective
        self.acquisition = acquisition
        self.evaluator = evaluator
        self.X = np.atleast_2d(X_init) if X_init is not None else None
        self.Y = np.atleast_2d(Y_init) if Y_init is not None else None
        from .cost import CostModel

        self.cost = cost if cost is not None else CostModel(None)
        self.normalize_Y = normalize_Y
        self.model_update_interval = model_update_interval
        self.de_duplication = de_duplication
        self.normalization_type = normalization_type
        self.num_acquisitions = 0
        self.model_parameters_iterations = None
        self.suggested_sample = None
        self.Y_new = None
        self._fit_failed = False

    # ------------------------------------------------------------------ ask-tell
    def suggest_next_locations(self, context=None, pending_X=None, ignored_X=None):
        """Ask interface (bo.py:55-71): fit on current (X, Y), return the next batch
        in objective space."""
        self.model_parameters_iterations = None
        self.num_acquisitions = 0
        self.context = context
        self._update_model(self.normalization_type)
        suggested_locations = self._compute_next_evaluations(
            pending_zipped_X=pending_X, ignored_zipped_X=ignored_X
        )
        return suggested_locations

    # ------------------------------------------------------------------ main loop
    def run_optimization(
        self,
        max_iter=0,
        max_time=np.inf,
        eps=1e-8,
        context=None,
        verbosity=False,
        save_models_parameters=True,
        report_file=None,
        evaluations_file=None,
        models_file=None,
    ):
        """(bo.py:73-197)"""
        self.verbosity = verbosity
        self.context = context
        if max_iter is None:
            max_iter = 0

        # initial evaluations
        if self.X is not None and self.Y is None:
            self.Y, cost_values = self.objective.evaluate(self.X)
            if self.cost.cost_type == "evaluation_time":
                self.cost.update_cost_model(self.X, cost_values)

        self.max_iter = max_iter
        self.max_time = max_time
        self.eps = eps
        self.cum_time = 0
        self.num_acquisitions = 0
        self.suggested_sample = self.X
        self.Y_new = self.Y
        self._fit_failed = False

        from ..utils.profiling import PhaseTimer

        self.phase_timer = PhaseTimer()
        while self.max_time > self.cum_time:
            zero_time = time.time()
            with self.phase_timer("fit"):
                self._update_model(self.normalization_type)
            if self._fit_failed:
                break  # bo.py:134-137: LinAlgError during fit ends the run
            if save_models_parameters:
                self._save_model_parameter_values()

            if (self.num_acquisitions >= self.max_iter) or (
                len(self.X) > 1
                and self._distance_last_evaluations() <= self.eps
            ):
                break

            with self.phase_timer("acquisition"):
                self.suggested_sample = self._compute_next_evaluations()
            self.X = np.vstack((self.X, self.suggested_sample))
            with self.phase_timer("objective"):
                self.evaluate_objective()

            self.cum_time += time.time() - zero_time
            self.num_acquisitions += 1
            if verbosity:
                print(
                    f"num acquisition: {self.num_acquisitions}, "
                    f"time elapsed: {self.cum_time:.2f}s"
                )
        if verbosity and self.num_acquisitions:
            print(self.phase_timer.report())

        self._compute_results()
        if report_file is not None:
            self.save_report(report_file)
        if evaluations_file is not None:
            self.save_evaluations(evaluations_file)
        if models_file is not None:
            self.save_models(models_file)

    # ------------------------------------------------------------------ internals
    def evaluate_objective(self):
        """(bo.py:191-197)"""
        self.Y_new, cost_new = self.objective.evaluate(self.suggested_sample)
        self.cost.update_cost_model(self.suggested_sample, cost_new)
        self.Y = np.vstack((self.Y, self.Y_new))

    def _distance_last_evaluations(self):
        """(bo.py:207)"""
        return np.sqrt(np.sum((self.X[-1, :] - self.X[-2, :]) ** 2))

    def _update_model(self, normalization_type="stats"):
        """Fit the surrogate on (unzipped X, normalized Y) (bo.py:236-254)."""
        if self.num_acquisitions % self.model_update_interval != 0:
            return
        X_inmodel = self.space.unzip_inputs(self.X)
        if self.normalize_Y:
            Y_inmodel = np.asarray(normalize_stats(self.Y))
        else:
            Y_inmodel = self.Y
        self.model.updateModel(X_inmodel, Y_inmodel, None, None)
        post = getattr(self.model, "posterior", None)
        if post is not None and post.ok is not None and not bool(post.ok):
            # one retry with a fresh restart key before giving up (the reference
            # breaks immediately on LinAlgError, bo.py:134-137; a single retry is
            # strictly more robust and changes nothing when the first fit succeeds)
            self.model.updateModel(X_inmodel, Y_inmodel, None, None)
            post = getattr(self.model, "posterior", None)
            if post is not None and post.ok is not None and not bool(post.ok):
                print("Warning: surrogate fit failed (non-PD covariance); stopping.")
                self._fit_failed = True
        self.X_inmodel = X_inmodel
        self.Y_inmodel = Y_inmodel

    def _compute_next_evaluations(self, pending_zipped_X=None, ignored_zipped_X=None):
        """(bo.py:216-235): context + dedup + evaluator batch, re-zipped."""
        context_manager = ContextManager(self.space, self.context if hasattr(self, "context") else None)
        self.acquisition.optimizer.context_manager = context_manager

        duplicate_manager = None
        if self.de_duplication:
            duplicate_manager = DuplicateManager(
                space=self.space,
                zipped_X=self.X,
                pending_zipped_X=pending_zipped_X,
                ignored_zipped_X=ignored_zipped_X,
            )
        suggested = self.evaluator.compute_batch(
            duplicate_manager=duplicate_manager, context_manager=context_manager
        )
        return self.space.zip_inputs(suggested)

    def _compute_results(self):
        """(bo.py:199-205)"""
        self.Y_best = np.minimum.accumulate(self.Y[:, 0])
        self.x_opt = self.X[np.argmin(self.Y[:, 0]), :]
        self.fx_opt = float(np.min(self.Y[:, 0]))

    def _save_model_parameter_values(self):
        """(bo.py:256)"""
        params = self.model.get_model_parameters()
        if self.model_parameters_iterations is None:
            self.model_parameters_iterations = params
        else:
            self.model_parameters_iterations = np.vstack(
                (self.model_parameters_iterations, params)
            )

    # ------------------------------------------------------------------ reports
    def save_report(self, report_file=None):
        """TSV report (bo.py:301-345)."""
        with open(report_file, "w") as f:
            import gaussian_process_optimization_tpu as pkg

            f.write("-----------------------------" + " GPO Report file " + "-----------------------------------\n")
            f.write(f"GPO Version {pkg.__version__}\n")
            f.write(f"Date and time: {time.strftime('%c')}\n")
            f.write(f"Optimization completed: {'YES' if self.X.shape[0] >= getattr(self, 'initial_iter', 0) else 'NO'}\n")
            f.write(f"Number initial samples: {getattr(self, 'initial_design_numdata', '-')}\n")
            f.write(f"Tolerance: {getattr(self, 'eps', '-')}\n")
            f.write(f"Optimization time: {self.cum_time if hasattr(self, 'cum_time') else '-'} seconds.\n\n")
            f.write("--------------------------------" + " Problem set up " + "------------------------------------\n")
            f.write(f"Problem dimension: {self.space.objective_dimensionality}\n")
            f.write(f"Number continuous variables: {len(self.space.get_continuous_dims())}\n")
            f.write(f"Number discrete variables: {len(self.space.get_discrete_dims())}\n")
            f.write(f"Number bandits: {sum(1 for v in self.space.space_expanded if v.is_bandit)}\n")
            f.write(f"Cost used: {self.cost.cost_type}\n")
            f.write(f"Constraints: {bool(self.space.constraints)}\n\n")
            f.write("------------------------------" + " Optimization set up " + "---------------------------------\n")
            f.write(f"Normalized outputs: {self.normalize_Y}\n")
            f.write(f"Model type: {type(self.model).__name__}\n")
            f.write(f"Acquisition type: {type(self.acquisition).__name__}\n")
            f.write(f"Evaluator type (batch size): {type(self.evaluator).__name__} ({self.evaluator.batch_size})\n\n")
            f.write("---------------------------------" + " Summary " + "------------------------------------------\n")
            f.write(f"Value at minimum: {self.fx_opt}\n")
            f.write(f"Best found minimum location: {self.x_opt}\n")

    def save_evaluations(self, evaluations_file=None):
        """Iteration\tY\tX TSV (bo.py:347-365)."""
        iterations = np.arange(1, self.Y.shape[0] + 1)[:, None]
        results = np.hstack([iterations, self.Y, self.X])
        header = ["Iteration", "Y"] + [f"var_{i+1}" for i in range(self.X.shape[1])]
        with open(evaluations_file, "w") as f:
            f.write("\t".join(header) + "\n")
            for row in results:
                f.write("\t".join(str(v) for v in row) + "\n")

    def save_models(self, models_file):
        """Per-iteration hyperparameters TSV (bo.py:367-392)."""
        if self.model_parameters_iterations is None:
            raise ValueError("No iterations have been carried out yet; cannot save models")
        iterations = np.arange(1, self.model_parameters_iterations.shape[0] + 1)[:, None]
        results = np.hstack([iterations, self.model_parameters_iterations])
        header = ["Iteration"] + list(self.model.get_model_parameters_names())
        with open(models_file, "w") as f:
            f.write("\t".join(header) + "\n")
            for row in results:
                f.write("\t".join(str(v) for v in row) + "\n")

    # ------------------------------------------------------------------ plots
    def plot_acquisition(self, filename=None, label_x=None, label_y=None):
        from ..utils.plotting import plot_acquisition

        # strip the padded buffer rows (gp.py pads X/Y to the bucket size with
        # zeros, which np.isfinite cannot distinguish from real observations)
        Xd = np.asarray(self.model.model.X)
        Yd = np.asarray(self.model.model.Y)
        m = getattr(self.model.model, "mask", None)
        if m is not None:
            keep = np.asarray(m) > 0
            Xd, Yd = Xd[keep], Yd[keep]
        return plot_acquisition(
            self.acquisition.space.get_bounds(),
            self.model.model.X.shape[1],
            self.model,
            Xd,
            Yd,
            self.acquisition.acquisition_function,
            self.suggest_next_locations(),
            filename=filename,
            label_x=label_x,
            label_y=label_y,
        )

    def plot_convergence(self, filename=None):
        from ..utils.plotting import plot_convergence

        return plot_convergence(self.X, self.Y_best, filename)

    def get_evaluations(self):
        return self.X.copy(), self.Y.copy()
