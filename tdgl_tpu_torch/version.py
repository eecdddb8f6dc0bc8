__version__ = "0.1.0"
__version_info__ = tuple(int(p) for p in __version__.split("."))
