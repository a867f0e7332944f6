"""The test sizes of ``sizes.py``, in the test process and, for the one test
that runs every cell in a fresh interpreter, in that interpreter too."""

import pytest

from benchmark.tests import sizes  # noqa: F401  (registers the sizes here)

#: the test that runs every cell in a fresh interpreter from its module's
#: ``_MODULES`` template
FRESH_CELLS = "test_a_cell_loads_no_jax"


@pytest.fixture(autouse=True)
def _sizes_in_fresh_interpreter(request, monkeypatch):
    if request.node.originalname == FRESH_CELLS:
        monkeypatch.setattr(request.module, "_MODULES",
                            "import benchmark.tests.sizes\n" + request.module._MODULES)
