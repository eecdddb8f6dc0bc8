"""The port's plots against the JAX package's: the ``Solution.plot_*`` aliases
and ``DynamicsData.plot``/``plot_dt`` on the port's output file, read by
each package. The fixture and the check are in
``tests/test_torch_visualize.py``.
"""

import pytest

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_visualize import (PLOT_METHODS, one_blas_thread,
                                  same_plot, solved)


@pytest.mark.parametrize("writer", ["torch"])
@pytest.mark.parametrize("name,draw", PLOT_METHODS,
                         ids=[p[0] for p in PLOT_METHODS])
def test_plot_functions(solved, writer, name, draw):
    same_plot(solved, writer, name, draw)
