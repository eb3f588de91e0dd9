"""Public API of the PyTorch port: ParMesh and its parameter enums.

The names load on first use, so that ``api.knobs`` imports without
torch (the polish worker reads its forced fault before importing it)."""

_LAZY = {"IParam": "params", "DParam": "params", "Info": "params",
         "ParMesh": "parmesh"}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
