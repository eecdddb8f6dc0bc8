"""Environment and dependency introspection (the counterpart of
:mod:`tdgl_tpu.about`, reference ``tdgl/about.py:54-103``).

Records the port's own version, python, the platform, numpy, scipy,
torch, the CUDA version torch was built with, and the card's name, in
place of the JAX package's jax/jaxlib versions and backend.
"""

from __future__ import annotations

import platform
import sys
from typing import Dict, Optional

from .version import __version__


def version_dict() -> Dict[str, str]:
    """Versions of tdgl_tpu_torch and its dependencies, plus platform and
    device info."""
    import numpy
    import scipy
    import torch

    versions = {
        "tdgl_tpu_torch": __version__,
        "python": sys.version,
        "platform": platform.platform(),
        "numpy": numpy.__version__,
        "scipy": scipy.__version__,
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
    }
    if torch.cuda.is_available():
        versions["cuda_device"] = torch.cuda.get_device_name(0)
    else:
        versions["cuda_device"] = "none"
    return versions


def version_table(version_info: Optional[Dict[str, str]] = None):
    """An HTML table of version info (for notebooks): an IPython ``HTML``
    object where IPython is installed, else the HTML string."""
    if version_info is None:
        version_info = version_dict()
    rows = ["<table>", "<tr><th>Software</th><th>Version</th></tr>"]
    for key, value in version_info.items():
        rows.append(f"<tr><td>{key}</td><td>{value}</td></tr>")
    rows.append("</table>")
    html = "".join(rows)
    try:
        from IPython.display import HTML
    except ImportError:
        return html
    return HTML(html)
