"""The hardened scipy optimizer wrapper behind ``find_MAP`` and the
``Experiment`` model-selection harness (the PyTorch counterpart of
:mod:`g3py_tpu.bayesian.selection`).

The harness runs on the host: per-simulation random splits of one dataset,
multi-start training of every model (the models' own ``find_MAP``, whose
evaluations run on the card), obs/valid/test scores and wall times, one
result row a (simulation, model) pair collected into a
:class:`~g3py_tpu_torch.utils.datatrace.Datatrace` and pickled to ``file``
after every row, so that a second ``run`` resumes where the first stopped.
``run_fanout`` trains the whole grid as one batched L-BFGS
(:mod:`.fanout`), its pairs split over the ranks of a mesh with
``shard=True``; ``engine='distributed'`` trains each model through the
band-sharded exact NLL, every rank of the mesh running the same experiment
(the same splits and starts; only rank 0 writes ``file``).
"""

import time

import numpy as np
import scipy.optimize as sp_optimize
import torch

from ..config import settings
from ..utils import DictObj, MaxTime, nan_to_high, save_pkl, load_pkl
from ..utils.datatrace import Datatrace

__all__ = ["optimize", "Experiment", "device_fault"]


def device_fault(err):
    """Whether an exception is a fault of the card or of a kernel (a failed
    build or launch, a CUDA error, device memory), which must surface, and
    not a numerical failure of one fit, which loses that candidate."""
    if isinstance(err, (torch.cuda.OutOfMemoryError, OSError, ImportError)):
        return True
    text = str(err)
    return any(word in text for word in ("CUDA", "cuda", "nvcc", "kernel launch",
                                         "cudaError"))


def optimize(logp, start, dlogp=None, fmin=None, max_time=None, disp=False):
    """Maximize ``logp`` from ``start`` with scipy fmin_bfgs (gradient when
    available) or fmin_powell.  The objective is hardened: NaN/Inf reads as
    1e100 and an exception as 1e32; a non-finite or failing gradient reads
    as 0.  A wall-clock budget (``max_time`` seconds) ends the search and
    returns the start, as does any optimizer error."""
    start = np.asarray(start, dtype=np.float64)

    def objective(p):
        try:
            return float(nan_to_high(-logp(p.astype(settings.floatx))))
        except Exception:
            return 1.0e32

    callback = None if max_time is None else MaxTime(max_time)
    if fmin is None:
        fmin = "bfgs" if dlogp is not None else "powell"
    try:
        if fmin == "bfgs" and dlogp is not None:
            def grad(p):
                try:
                    g = -np.asarray(dlogp(p.astype(settings.floatx)), dtype=np.float64)
                    return np.where(np.isfinite(g), g, 0.0)
                except Exception:
                    return np.zeros_like(p)

            out = sp_optimize.fmin_bfgs(objective, start, fprime=grad, disp=disp,
                                        callback=callback)
        elif fmin == "bfgs":
            out = sp_optimize.fmin_bfgs(objective, start, disp=disp, callback=callback)
        else:
            out = sp_optimize.fmin_powell(objective, start, disp=disp, callback=callback)
    except TimeoutError:
        if disp:
            print("Optimization time limit reached")
        return start.astype(settings.floatx)
    except Exception as m:
        if disp:
            print("Optimization error:", m)
        return start.astype(settings.floatx)
    return np.atleast_1d(np.asarray(out)).astype(settings.floatx)


class Experiment:
    """Repeated-simulation model-selection benchmark: per-simulation random
    splits, multi-start training per model, obs/valid/test scores and
    wall-times persisted to ``file`` with resume-on-restart."""

    def __init__(self, models=None, file=None, load=True):
        self.models = list(models) if models is not None else []
        self.file = file
        self.data_x = None
        self.data_y = None
        self.data_p = None
        self.data_limit = 1
        self.data_method = "random"
        self.scores_mean = True
        self.scores_median = False
        self.scores_variance = True
        self.scores_logp = True
        self.scores_time = True
        self.find_MAP = True
        self.starts = 1
        self.master = None
        self.points = 1
        self.powell = True
        self.max_time = None
        # training engine of select_model: "scipy", "jax" (the batched
        # L-BFGS), "iterative" (matrix-free, GP family) or "distributed"
        # (the band-sharded exact NLL on every rank of a mesh); engine
        # knobs (mesh, block, axis, ...) go in engine_kwargs
        self.engine = "scipy"
        self.engine_kwargs = {}
        # training objective: 'logp' (marginal likelihood) or 'loo'
        self.objective = "logp"
        # selection among the optimized starts: '_l2' (holdout error) or
        # 'loo' (the training set's LOO pseudo-likelihood)
        self.selection = "_l2"
        self.holdout = 0.0
        self.results = None
        self.simulations = {}
        if file is not None and load:
            try:
                state = load_pkl(file)
                self.__dict__.update(state)
                print("Loaded experiment " + file)
            except Exception:
                pass

    # -- configuration ----------------------------------------------------------
    def add_model(self, model):
        self.models.append(model)

    def set_data(self, x, y, p=0.5, limit=1.0, method="random", holdout=0.0):
        self.data_x = np.asarray(x)
        self.data_y = np.asarray(y)
        self.data_p = p
        self.data_limit = limit
        self.data_method = method
        self.holdout = holdout

    def set_scores(self, mean=True, median=False, variance=True, logp=True, time=True):
        self.scores_mean = mean
        self.scores_median = median
        self.scores_variance = variance
        self.scores_logp = logp
        self.scores_time = time

    def set_selection(self, find_MAP=True, starts=1, points=1, powell=True, master=None,
                      max_time=None, engine="scipy", engine_kwargs=None, objective="logp",
                      selection="_l2"):
        self.find_MAP = find_MAP
        self.starts = starts
        self.points = points
        self.powell = powell
        self.master = master
        self.max_time = max_time
        self.engine = engine
        self.engine_kwargs = engine_kwargs or {}
        if objective not in ("logp", "loo"):
            raise ValueError(f"unknown objective {objective!r}")
        if selection not in ("_l2", "loo"):
            raise ValueError(f"unknown selection {selection!r} "
                             "('_l2' holdout error | 'loo' internal CV)")
        self.objective = objective
        self.selection = selection

    def save(self, path=None):
        path = path or self.file
        if path is None or (torch.distributed.is_available()
                            and torch.distributed.is_initialized()
                            and torch.distributed.get_rank() != 0):
            return  # one writer a world
        save_pkl({k: v for k, v in self.__dict__.items() if k != "models"}, path)

    # -- data splits --------------------------------------------------------------
    def new_data(self, seed=None):
        """(obs, valid, test) indices of a split drawn from
        ``default_rng(seed)``; the first ``holdout`` share of the observed
        indices is the validation set."""
        from ..utils.data import random_obs, uniform_obs

        rng = np.random.default_rng(seed)
        n = len(self.data_x)
        limit = int(self.data_limit * n) if self.data_limit <= 1 else int(self.data_limit)
        if self.data_method == "uniform":
            obs_i, test_i = uniform_obs(self.data_x[:limit], self.data_p)
        else:
            obs_i, test_i = random_obs(self.data_x[:limit], self.data_p, rng=rng)
        valid_i = np.array([], dtype=int)
        if self.holdout > 0:
            k = int(len(obs_i) * self.holdout)
            valid_i = obs_i[:k]
            obs_i = obs_i[k:]
        return obs_i, valid_i, test_i

    # -- selection ----------------------------------------------------------------
    def select_model(self, sp, valid_index=None, display=False):
        """Multi-start training from the defaults, ``starts - 1`` random
        perturbations of them and the master model's params.  Without a
        holdout the best start by the objective wins; with one, the
        optimized candidate of smallest holdout ``_l2``; with
        ``selection='loo'``, the candidate of largest training LOO."""
        # the band-sharded engine runs alike on every rank: its random starts
        # come from one seed there
        rng = np.random.default_rng(0) if self.engine == "distributed" else None
        starts = [sp.params_default]
        for _ in range(max(self.starts - 1, 0)):
            starts.append(sp.params_random(mean=sp.params_default, sigma=0.2, rng=rng))
        if self.master is not None and self.master is not sp:
            try:
                starts.append(sp.params_process(process=self.master))
            except Exception:
                pass
        if not self.find_MAP:
            best, best_ll = None, -np.inf
            for s in starts:
                ll = sp.logp(s)
                if ll > best_ll:
                    best, best_ll = s, ll
            return best
        if self.engine != "scipy":
            params, points_list = sp.find_MAP(
                start=starts, points=self.points, display=display, engine=self.engine,
                return_points=True, objective=self.objective, **(self.engine_kwargs or {}))
        else:
            params, points_list = sp.find_MAP(
                start=starts, points=self.points, powell=self.powell, display=display,
                max_time=self.max_time, objective=self.objective, return_points=True)
        if self.selection == "loo":
            if not hasattr(sp, "loo"):
                raise ValueError(f"selection='loo' needs models exposing .loo (the GP family "
                                 f"does); {type(sp).__name__} does not")
            best, best_score = params, -np.inf
            for _name, _ll, cand in points_list:
                try:
                    score = float(sp.loo(DictObj(cand)))
                except Exception:
                    score = -np.inf
                if np.isfinite(score) and score > best_score:
                    best, best_score = DictObj(cand), score
            return best
        if valid_index is None or len(valid_index) == 0:
            return params
        best, best_score = params, np.inf
        for _name, _ll, cand in points_list:
            try:
                score = float(self.calc_scores(sp, DictObj(cand), valid_index).get("_l2", np.inf))
            except Exception:
                score = np.inf
            if np.isfinite(score) and score < best_score:
                best, best_score = DictObj(cand), score
        return best

    def calc_scores(self, sp, params, index):
        if len(index) == 0:
            return DictObj()
        return sp.scores(params, space=self.data_x[index], hidden=self.data_y[index],
                         logp=self.scores_logp, variance=self.scores_variance,
                         median=self.scores_median)

    def add_result(self, row):
        """Append a result row (columns in order of first appearance, a
        missing value NaN) and save."""
        rows = [] if self.results is None else [r for _, r in self.results.iterrows()]
        rows.append(dict(row))
        columns = list(dict.fromkeys(k for r in rows for k in r))
        self.results = Datatrace.from_rows(rows, columns)
        if self.file is not None:
            self.save()

    def _score_row(self, sp, sim, params, obs_i, valid_i, test_i, time_obs, time_params,
                   display, tag=""):
        """Score ``params`` on the obs/valid/test indices and add the row."""
        row = DictObj()
        row["_simulation"] = sim
        row["_model"] = sp.name
        row["time_obs"] = time_obs
        row["time_params"] = time_params
        t0 = time.time()
        for k, v in self.calc_scores(sp, params, obs_i).items():
            row["obs" + k] = v
        row["time_scores_obs"] = time.time() - t0
        if len(valid_i):
            t0 = time.time()
            for k, v in self.calc_scores(sp, params, valid_i).items():
                row["valid" + k] = v
            row["time_valid"] = time.time() - t0
        t0 = time.time()
        for k, v in self.calc_scores(sp, params, test_i).items():
            row["test" + k] = v
        row["time_test"] = time.time() - t0
        for k, v in params.items():
            v = v.detach().cpu().numpy() if hasattr(v, "detach") else v
            row[k] = np.asarray(v)
        self.add_result(row)
        if display:
            print(f"sim {sim} model {sp.name}{tag}: "
                  + str({k: v for k, v in row.items() if k.startswith("test")}))

    def run(self, n_simulations=1, repeat=False, display=False):
        """Per (simulation, model): observe the split, train, score the
        obs/valid/test indices, and add the row; pairs already in the
        results are skipped unless ``repeat``."""
        for sim in range(n_simulations):
            if sim not in self.simulations:
                self.simulations[sim] = self.new_data(seed=sim)
            obs_i, valid_i, test_i = self.simulations[sim]
            for sp in self.models:
                if self.results is not None and not repeat and np.any(
                        (self.results["_simulation"] == sim)
                        & (self.results["_model"] == sp.name)):
                    continue
                t0 = time.time()
                sp.observed(self.data_x[obs_i], self.data_y[obs_i])
                time_obs = time.time() - t0
                t0 = time.time()
                params = self.select_model(sp, valid_index=valid_i, display=display)
                time_params = time.time() - t0
                self._score_row(sp, sim, params, obs_i, valid_i, test_i, time_obs,
                                time_params, display)
        return self.results

    def run_fanout(self, n_simulations=1, repeat=False, display=False, points=None,
                   max_iters=200, shard=False, mesh=None):
        """``run`` with the training grid fused: every (simulation, start)
        pair of a model trains at once through the masked loglike
        (:func:`~g3py_tpu_torch.bayesian.fanout.fit_splits`), S x K
        optimizations as rows of one batched L-BFGS instead of S x K scipy
        fits.  The same splits, scores, result rows and resume as ``run``;
        the starts are the full-data defaults plus perturbations; with a
        holdout, the grid's optimized candidate of smallest validation
        ``_l2`` wins.  Needs every model to have ``th_loglike_masked_fn``
        (the GP, WGP and TP families); ``shard=True`` splits the grid's
        pairs over the ranks of ``mesh`` (every rank running the same
        experiment)."""
        from .fanout import fit_splits

        if points is None:
            points = max(self.points, self.starts, 1)
        sims = {}
        for sim in range(n_simulations):
            if sim not in self.simulations:
                self.simulations[sim] = self.new_data(seed=sim)
            sims[sim] = self.simulations[sim]
        # the limit rule of new_data: a fraction when <= 1, a count otherwise
        n_all = (int(self.data_limit) if self.data_limit > 1
                 else int(self.data_limit * len(self.data_x)))
        x_all = np.asarray(self.data_x[:n_all])
        y_all = np.asarray(self.data_y[:n_all])
        for sp in self.models:
            if not hasattr(sp, "th_loglike_masked_fn"):
                raise ValueError(f"model {sp.name} has no masked loglike; use run()")
            todo = [sim for sim in range(n_simulations)
                    if repeat or self.results is None or not np.any(
                        (self.results["_simulation"] == sim)
                        & (self.results["_model"] == sp.name))]
            if not todo:
                continue
            sp.observed(x_all, y_all)
            masks = np.zeros((len(todo), len(x_all)), np.float32)
            for row_i, sim in enumerate(todo):
                masks[row_i, sims[sim][0]] = 1.0
            t0 = time.time()
            plist, _, pts = fit_splits(sp, masks, points=points, max_iters=max_iters,
                                       shard=shard, mesh=mesh, return_points=True)
            grid_time = time.time() - t0
            reg = sp.active
            for row_i, sim in enumerate(todo):
                obs_i, valid_i, test_i = sims[sim]
                t0 = time.time()
                sp.observed(x_all[obs_i], y_all[obs_i])
                time_obs = time.time() - t0
                params = plist[row_i]
                if len(valid_i):
                    best_score = np.inf
                    for k in range(pts.shape[1]):
                        cand = DictObj(reg.array_to_dict(pts[row_i, k]))
                        try:
                            score = float(self.calc_scores(sp, cand, valid_i).get("_l2",
                                                                                  np.inf))
                        except Exception as err:
                            if device_fault(err):
                                raise
                            score = np.inf
                        if np.isfinite(score) and score < best_score:
                            params, best_score = cand, score
                # run()'s timing columns: the grid's time shared evenly by its rows
                self._score_row(sp, sim, params, obs_i, valid_i, test_i, time_obs,
                                grid_time / len(todo), display, " (fanout)")
        return self.results

    # -- reporting ------------------------------------------------------------------
    def describe(self, score="test_l2"):
        """The mean ``score`` per simulation (rows, ``_simulation``) and
        model (one column each, sorted by name), NaN where a pair has no
        result: pandas' ``pivot_table`` of the results."""
        if self.results is None:
            return None
        sims, models = self.results["_simulation"], self.results["_model"]
        values = np.asarray(self.results[score], dtype=np.float64)
        keys = np.unique(sims)
        out = {"_simulation": keys}
        for m in sorted(set(models.tolist())):
            out[m] = np.array([np.mean(values[(sims == k) & (models == m)])
                               if np.any((sims == k) & (models == m)) else np.nan
                               for k in keys])
        return Datatrace(out)

    def plot(self, score="test_l2", kind="violin"):
        """The score of each model over the simulations, as a violin (or a
        swarm) plot."""
        import seaborn as sb

        if self.results is None:
            return
        df = {c: self.results[c] for c in ("_model", score)}
        if kind == "violin":
            sb.violinplot(data=df, x="_model", y=score)
        else:
            sb.swarmplot(data=df, x="_model", y=score)
