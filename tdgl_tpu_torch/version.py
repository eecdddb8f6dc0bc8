__version__ = "0.1.0"
__version_info__ = tuple(int(p) for p in __version__.split("."))


def _git_revision():
    """The short git revision of the checkout holding this package, or
    None outside a git checkout."""
    import os
    import subprocess

    try:
        here = os.path.dirname(os.path.abspath(__file__))
        rev = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=here, capture_output=True, text=True, timeout=5,
        )
        return rev.stdout.strip() or None
    except Exception:
        return None


__git_revision__ = _git_revision()
