"""Test sizes of the configurations that ``small.py`` does not list, added
to its ``SMALL`` on import: ``conftest.py`` imports this in the test
process, and a test that runs cells in a fresh interpreter imports it there
first."""

from benchmark.tests import small

small.SMALL.setdefault("ba-ring89", dict(n_cams=16, n_points=600, obs_per_point=5))
