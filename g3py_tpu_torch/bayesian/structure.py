"""Compositional kernel structure search (Duvenaud et al., ICML 2013; the
PyTorch counterpart of :mod:`g3py_tpu.bayesian.structure`).

A greedy search over the kernel algebra: start from each base family, then
repeatedly extend the incumbent with ``+ B`` and ``* B`` for every base
``B`` (``expand='root'``) or by the full grammar at every subexpression
(``expand='all'``), keeping an extension only when the model-selection
criterion improves.  Structures are expression trees, instantiated fresh for
every fit; each candidate fit is an ordinary ``find_MAP`` (K1 and K2 on the
card for every SE/MAT52 leaf and every factorization).

A candidate that fails numerically loses (criterion inf); a fault of the
card or of a kernel (a failed build or launch, a CUDA error, device memory)
is raised, never scored as a loss.
"""

import numpy as np
import torch

from ..config import settings
from .selection import device_fault

__all__ = ["search_kernel", "KernelSearch"]

#: the failures of one candidate's fit that make it lose, not the search
_FIT_FAILURES = (ArithmeticError, ValueError, RuntimeError, torch.linalg.LinAlgError)


class _ModelSpecError(TypeError):
    """A mis-specified ``model=`` factory — a user error that must not be
    swallowed by the per-candidate failure handler."""


def _node_name(node):
    if isinstance(node, str):
        return node
    op, a, b = node
    return f"({_node_name(a)} {op} {_node_name(b)})"


def _subexpr_paths(node, path=()):
    """Yield the path of every subexpression (root first); a path is a
    tuple of 1/2 child indices into the (op, a, b) tuples."""
    yield path
    if not isinstance(node, str):
        _, a, b = node
        yield from _subexpr_paths(a, path + (1,))
        yield from _subexpr_paths(b, path + (2,))


def _get(node, path):
    for i in path:
        node = node[i]
    return node


def _replace(node, path, new):
    if not path:
        return new
    op, a, b = node
    if path[0] == 1:
        return (op, _replace(a, path[1:], new), b)
    return (op, a, _replace(b, path[1:], new))


def _expansions(node, bases):
    """The full CKS grammar (Duvenaud 2013 §2.3) applied to every
    subexpression S of the incumbent: S -> S + B, S -> S * B for every
    base B, and B -> B' at every leaf.  Deduplicated by name; the
    incumbent itself is never emitted."""
    home = _node_name(node)
    seen, out = {home}, []

    def emit(cand):
        nm = _node_name(cand)
        if nm not in seen:
            seen.add(nm)
            out.append(cand)

    for path in _subexpr_paths(node):
        sub = _get(node, path)
        for b in bases:
            for op in ("+", "*"):
                emit(_replace(node, path, (op, sub, b)))
        if isinstance(sub, str):
            for b in bases:
                if b != sub:
                    emit(_replace(node, path, b))
    return out


def _build(node, x, zoo, _counter=None):
    """Instantiate an expression tree.  Every occurrence gets a UNIQUE
    component name (SE0, SE1, ...) — with the default class names, two
    SE parts in one structure would collide to the SAME hyper names and
    silently share parameters (k stays 4 for (SE + SE))."""
    import itertools

    if _counter is None:
        _counter = itertools.count()
    if isinstance(node, str):
        return zoo[node](x, name=f"{node}{next(_counter)}")
    op, a, b = node
    ka = _build(a, x, zoo, _counter)
    kb = _build(b, x, zoo, _counter)
    return ka + kb if op == "+" else ka * kb


class KernelSearch:
    """Result container: ``best`` (expression tree), ``best_name``,
    ``gp``/``params`` (the winning fitted process), and ``table`` (one
    row per evaluated structure: name, loglike, n_params, criterion —
    the criterion column is the score named by ``search_kernel``'s
    ``criterion=``, lower is better)."""

    def __init__(self, best, gp, params, table, zoo, x):
        self.best = best
        self.best_name = _node_name(best)
        self.gp = gp
        self.params = params
        self.table = table
        self._zoo = zoo
        self._x = x

    def best_kernel(self, x=None):
        """A FRESH instance of the winning kernel structure (pass to any
        process constructor)."""
        return _build(self.best, self._x if x is None else x, self._zoo)

    def __repr__(self):
        return (f"KernelSearch[best={self.best_name}, "
                f"evaluated={len(self.table)}]")


def search_kernel(x, y, bases=("SE", "LIN", "SIN", "MAT52"), depth=2,
                  criterion="bic", points=1, model=None, zoo=None,
                  expand="root", display=False, **fit_kwargs):
    """Greedy compositional kernel search.

    Parameters
    ----------
    x, y : arrays
        Training data ((n, d) and (n,)).
    bases : tuple of str
        Base families (names resolved in ``zoo``, default the kernel
        zoo: any class taking ``(x)`` — SE, MAT32/52, RQ, LIN, SIN, ...).
    depth : int
        Number of greedy extension rounds after the base round.
    expand : 'root' | 'all'
        ``'root'`` (default) extends only the incumbent's root with
        ``+ B`` / ``* B`` (first-improvement, cheap).  ``'all'`` runs
        the FULL CKS grammar (Duvenaud et al. 2013): every
        subexpression S of the incumbent tries ``S + B``, ``S * B``,
        and leaf swaps ``B -> B'``; the round's best-scoring candidate
        wins.  Costs O(tree size x |bases|) fits per round but can
        reach structures root extension cannot (e.g. replacing a base
        deep inside a product).
    criterion : 'bic' | 'aic' | 'loglike' | 'loo'
        Model-selection score (lower is better; loglike is negated).
        ``'loo'`` scores by negative leave-one-out pseudo-likelihood
        (GPML §5.4.2; model must expose ``loo`` — the GP family does):
        held-out prediction quality directly, no parameter-count
        penalty needed.
    points : int
        ``find_MAP`` multi-start count per candidate fit.
    model : callable, optional
        ``model(kernel) -> process`` factory; defaults to a noisy exact
        GP with a Bias location.  The process must implement
        ``observed``/``find_MAP``/``loglike``.
    zoo : dict, optional
        name -> kernel-class overrides; defaults to the package zoo.

    Returns
    -------
    KernelSearch
    """
    from ..hypers import kernels as _kz
    from ..hypers.means import Bias
    from ..models.gaussian import GaussianProcess

    if criterion not in ("bic", "aic", "loglike", "loo"):
        raise ValueError(f"unknown criterion {criterion!r}")
    if expand not in ("root", "all"):
        raise ValueError(f"unknown expand mode {expand!r}")
    x = np.asarray(x, dtype=settings.floatx)
    if x.ndim == 1:
        x = x[:, None]
    y = np.asarray(y, dtype=settings.floatx)
    n = len(y)
    if zoo is None:
        zoo = {name: getattr(_kz, name) for name in bases}
    else:
        zoo = dict(zoo)

    if model is None:
        def model(kernel):
            return GaussianProcess(space=x[: min(4, n)], location=Bias(),
                                   kernel=kernel, noisy=True,
                                   name="KSearch")

    fit_kwargs.setdefault("powell", False)
    fit_kwargs.setdefault("display", False)

    table = []
    cache = {}

    def score(node):
        name = _node_name(node)
        if name in cache:
            return cache[name]
        try:
            gp = model(_build(node, x, zoo))
            if criterion == "loo" and not hasattr(gp, "loo"):
                # fail fast instead of every candidate silently scoring
                # inf through the broad except below
                raise _ModelSpecError(
                    "criterion='loo' needs model instances exposing "
                    f".loo; {type(gp).__name__} does not")
            gp.observed(x, y)
            params = gp.find_MAP(points=points, **fit_kwargs)
            ll = float(gp.loglike(params))
            k = int(np.asarray(gp.active.sampling_params(params)).size)
            if criterion == "bic":
                crit = k * np.log(n) - 2.0 * ll
            elif criterion == "aic":
                crit = 2.0 * k - 2.0 * ll
            elif criterion == "loo":
                # leave-one-out pseudo-likelihood (GPML 5.4.2): unlike
                # the in-sample marginal likelihood it directly scores
                # held-out prediction, so it needs no parameter-count
                # penalty term
                crit = -float(gp.loo(params))
            else:  # 'loglike' (validated above)
                crit = -ll
            if not np.isfinite(crit):
                crit = np.inf
            out = (crit, gp, params, ll, k)
        except _ModelSpecError:
            raise
        except _FIT_FAILURES as m:  # a candidate that cannot fit just loses
            if device_fault(m):
                raise
            if display:
                print(f"  {name}: failed ({m})")
            out = (np.inf, None, None, -np.inf, 0)
        cache[name] = out
        table.append({"name": name, "loglike": out[3], "n_params": out[4],
                      "criterion": out[0]})
        if display and np.isfinite(out[0]):
            print(f"  {name}: {criterion}={out[0]:.1f} "
                  f"(loglike {out[3]:.1f}, k={out[4]})")
        return out

    # round 0: the bases
    best_node, best = None, (np.inf, None, None, -np.inf, 0)
    for b in bases:
        s = score(b)
        if s[0] < best[0]:
            best_node, best = b, s
    if best_node is None:
        raise RuntimeError(
            "search_kernel: every base kernel failed to fit "
            f"({', '.join(bases)}) — see the per-candidate messages "
            "with display=True")
    if display:
        print(f"base round: {_node_name(best_node)}")

    # greedy extensions.  'root' is first-improvement (later candidates
    # in the same round extend the already-improved incumbent); 'all'
    # scores the full grammar neighborhood and takes the round's best.
    for level in range(depth):
        improved = False
        if expand == "all":
            round_node, round_best = None, best
            for cand in _expansions(best_node, bases):
                s = score(cand)
                if s[0] < round_best[0]:
                    round_node, round_best = cand, s
            if round_node is not None:
                best_node, best = round_node, round_best
                improved = True
        else:
            for b in bases:
                for op in ("+", "*"):
                    cand = (op, best_node, b)
                    s = score(cand)
                    if s[0] < best[0]:
                        best_node, best = cand, s
                        improved = True
        if display:
            print(f"depth {level + 1}: {_node_name(best_node)}")
        if not improved:
            break

    return KernelSearch(best_node, best[1], best[2], table, zoo, x)
