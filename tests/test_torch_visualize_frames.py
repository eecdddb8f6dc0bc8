"""The port's ``generate_snapshots`` and ``create_animation`` against the JAX
package's, on each package's output file.

The fixture and the figure checks are in ``tests/test_torch_visualize.py``.
"""

import os

import pytest

import tdgl_tpu.visualization as jvis
import tdgl_tpu_torch.visualization as tvis

# Imported fixtures apply here: the autouse ones, and those that the
# imported ones request.
from test_torch_visualize import (WRITERS, _same_figures, one_blas_thread,
                                  solved)


@pytest.mark.parametrize("writer", WRITERS)
def test_generate_snapshots(solved, writer):
    path, _ = solved[writer]
    kw = dict(times=[0.0, 0.05, 1.0], quantities=["order_parameter",
                                                   "supercurrent", "vorticity"],
              axis_labels=True)
    with tvis.non_gui_backend():
        ours = tvis.generate_snapshots(path, **kw)
        theirs = jvis.generate_snapshots(path, **kw)
        assert len(ours) == len(theirs) == 3
        for i, ((fa, _), (fb, _)) in enumerate(zip(ours, theirs)):
            _same_figures(fa, fb, ("snapshot", i))


@pytest.mark.parametrize("writer", WRITERS)
def test_create_animation(solved, writer, tmp_path):
    path, _ = solved[writer]
    figs = []
    for vis, tag in ((tvis, "t"), (jvis, "j")):
        out = str(tmp_path / f"{tag}.gif")
        anim = vis.create_animation(
            path, output_file=out, quantities=["order_parameter", "phase"],
            fps=10, min_frame=1, max_frame=3, full_title=False, silent=True)
        assert os.path.getsize(out) > 0
        figs.append(anim._fig)
    _same_figures(*figs, "animation's last frame")
