"""Port parity of ``search_kernel``'s full grammar (``expand='all'``)
against the JAX package's, float64: the winner, and every evaluated
structure's loglike and criterion at 1e-6 relative (the helper and the
``root`` grammar: tests/test_torch_structure.py)."""

from test_torch_structure import search_matches_jax


def test_search_all_matches_jax():
    search_matches_jax("all")
