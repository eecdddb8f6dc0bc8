"""The key events of the port's ``InteractivePlot`` and
``MultiInteractivePlot`` against the JAX package's (mirrors of
``tests/test_visualize.py:122,176``), on each package's output file.

The fixture and the figure checks are in ``tests/test_torch_visualize.py``.
"""

import h5py
import numpy as np
import pytest

import tdgl_tpu.visualization as jvis
import tdgl_tpu_torch.visualization as tvis
from tdgl_tpu_torch.utils import h5lite

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_visualize import WRITERS, _close, one_blas_thread, solved


def _press_all(plot, f, keys):
    """Build ``plot`` on ``f``, press ``keys`` and record the frame, the
    quantity and every collection's array after each."""
    import matplotlib.pyplot as plt
    from matplotlib.backend_bases import KeyEvent

    fig = plot._build(f)
    colls = getattr(plot, "_collections", None) or [plot._pc]
    out = []
    for key in keys:
        plot._on_key(KeyEvent("key_press_event", fig.canvas, key))
        out.append((plot._frames.current,
                    getattr(plot, "quantity", None),
                    [np.array(c.get_array()) for c in colls]))
    plt.close(fig)
    return out


KEYS = {
    "InteractivePlot": ["right", "left", "left", "end", "up", "home",
                        "shift+right", "shift+left", "up", "down", "shift+up",
                        "shift+down", "3", "right", "9", "5", "1"],
    "MultiInteractivePlot": ["right", "left", "left", "end", "up", "home",
                             "shift+right"],
}


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("kind", ["InteractivePlot", "MultiInteractivePlot"])
def test_interactive_key_events(solved, writer, kind):
    """The key sequence of ``tests/test_visualize.py:122,176`` (frame jumps
    clipped to the file's range, number keys selecting the quantity)
    moves both packages' plots through the same frames and arrays."""
    path, _ = solved[writer]
    with tvis.non_gui_backend():
        with h5lite.File(path, "r") as f:
            ours = _press_all(getattr(tvis, kind)(path), f, KEYS[kind])
        with h5py.File(path, "r") as f:
            theirs = _press_all(getattr(jvis, kind)(path), f, KEYS[kind])
    frames = [o[0] for o in ours]
    assert frames == [o[0] for o in theirs]
    assert frames[:6] == [1, 0, 0, 5, 5, 0]
    for (_, qa, aa), (_, qb, ab) in zip(ours, theirs):
        assert (qa and qa.name) == (qb and qb.name)
        for a, b in zip(aa, ab):
            _close(a, b, kind)
    if kind == "InteractivePlot":
        assert [o[1].name for o in ours[-5:]] == [
            "SUPERCURRENT", "SUPERCURRENT", "VORTICITY", "SCALAR_POTENTIAL",
            "ORDER_PARAMETER"]
        assert not np.array_equal(ours[11][2][0], ours[12][2][0])
    else:
        assert not np.array_equal(ours[5][2][0], ours[6][2][0])
