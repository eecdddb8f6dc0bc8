"""The port's plots against the JAX package's: the module's plot functions
(``plot_currents``, twice, ``plot_order_parameter``, ``plot_vorticity``,
``plot_scalar_potential`` and ``plot_field_at_positions``) on the JAX
package's output file, read by each package. The fixture and the check are
in ``tests/test_torch_visualize.py``.
"""

import pytest

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_visualize import (PLOT_FUNCTIONS, one_blas_thread,
                                  same_plot, solved)


@pytest.mark.parametrize("writer", ["jax"])
@pytest.mark.parametrize("name,draw", PLOT_FUNCTIONS,
                         ids=[p[0] for p in PLOT_FUNCTIONS])
def test_plot_functions(solved, writer, name, draw):
    same_plot(solved, writer, name, draw)
