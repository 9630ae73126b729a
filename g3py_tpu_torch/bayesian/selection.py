"""The hardened scipy optimizer wrapper behind ``find_MAP`` (the PyTorch
counterpart of :func:`g3py_tpu.bayesian.selection.optimize`; the
``Experiment`` harness is not ported yet)."""

import numpy as np
import scipy.optimize as sp_optimize

from ..config import settings
from ..utils import MaxTime, nan_to_high

__all__ = ["optimize"]


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
