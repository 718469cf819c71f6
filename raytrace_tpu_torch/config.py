"""Two-tier run configuration: par files overridden by CLI arguments.

Counterpart of ``raytrace_tpu/config.py`` (reference ``par_file.h`` +
``par_args.h``), without its JAX platform and compilation-cache switches:
the port's device is an explicit argument.

  * Parameter files are ``name = value`` text, ``#`` comments, whitespace
    tolerant; values may be scalars or space-separated arrays
    (``source = 0 5 1E-3 1.5707``).
  * CLI arguments are ``--key=value`` (par_args.h:18) and override the par
    file per key (emissivity.cpp:36-37).
  * Typed getters: a missing key raises unless a default is supplied.
"""

from __future__ import annotations

import sys
from typing import Sequence


class ParameterError(KeyError):
    """Missing required parameter (par_file.h:20-35)."""


_SENTINEL = object()


def _convert(value: str, typ):
    if typ is bool:
        v = value.strip().lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse boolean from {value!r}")
    if typ is int:
        # tolerate scientific-notation ints ("1E5")
        f = float(value)
        if f != int(f):
            raise ValueError(f"non-integer value {value!r} for int parameter")
        return int(f)
    return typ(value)


class ParameterFile:
    """``name = value`` parameter file (par_file.h:38-206)."""

    def __init__(self, filename: str | None = None, text: str | None = None):
        self._params: dict[str, str] = {}
        if filename is not None:
            with open(filename) as f:
                text = f.read()
        if text is not None:
            for line in text.splitlines():
                line = line.split("#", 1)[0].strip()
                if not line or "=" not in line:
                    continue
                key, _, value = line.partition("=")
                self._params[key.strip()] = value.strip()

    def key_exists(self, key: str) -> bool:
        return key in self._params

    def get(self, key: str, typ=float, default=_SENTINEL):
        if key not in self._params:
            if default is _SENTINEL:
                raise ParameterError(f"required parameter '{key}' not found")
            return default
        return _convert(self._params[key], typ)

    def get_array(self, key: str, typ=float, n: int | None = None):
        if key not in self._params:
            raise ParameterError(f"required parameter '{key}' not found")
        vals = [_convert(v, typ) for v in self._params[key].split()]
        if n is not None and len(vals) < n:
            raise ParameterError(f"parameter '{key}' needs {n} values, got {len(vals)}")
        return vals[:n] if n is not None else vals


class ParameterArgs:
    """``--key=value`` command-line arguments (par_args.h:39-219)."""

    def __init__(self, argv: Sequence[str] | None = None):
        argv = list(sys.argv[1:] if argv is None else argv)
        self._params: dict[str, str] = {}
        self._positional: list[str] = []
        for arg in argv:
            if arg.startswith("--"):
                key, sep, value = arg.partition("=")
                self._params[key] = value if sep else "1"
            else:
                self._positional.append(arg)

    def key_exists(self, key: str) -> bool:
        if not key.startswith("--"):
            key = "--" + key
        return key in self._params

    def get(self, key: str, typ=float, default=_SENTINEL):
        if not key.startswith("--"):
            key = "--" + key
        if key not in self._params:
            if default is _SENTINEL:
                raise ParameterError(f"required argument '{key}' not found")
            return default
        return _convert(self._params[key], typ)

    @property
    def positional(self) -> list[str]:
        """The arguments that are not ``--key[=value]``, in order."""
        return self._positional


class Config:
    """CLI-over-par-file lookup, collapsing the per-app boilerplate the
    reference repeats in every main() (emissivity.cpp:32-55)."""

    def __init__(self, argv: Sequence[str] | None = None, default_parfile: str | None = None):
        """``--parfile=`` names the par file; without it, ``default_parfile``
        (none by default)."""
        self.args = ParameterArgs(argv)
        parfile = self.args.get("parfile", str, default_parfile)
        self.par = ParameterFile(parfile) if parfile else ParameterFile(text="")
        self.parfile = parfile

    def get(self, key: str, typ=float, default=_SENTINEL):
        if self.args.key_exists(key):
            return self.args.get(key, typ)
        if default is _SENTINEL:
            return self.par.get(key, typ)
        return self.par.get(key, typ, default)

    def key_exists(self, key: str) -> bool:
        return self.args.key_exists(key) or self.par.key_exists(key)

    def get_array(self, key: str, typ=float, n: int | None = None):
        # CLI overrides the par file here too: --source="0 5 1e-3 0"
        if self.args.key_exists(key):
            vals = [_convert(v, typ) for v in self.args.get(key, str).split()]
            if n is not None and len(vals) < n:
                raise ParameterError(
                    f"parameter '{key}' needs {n} values, got {len(vals)}")
            return vals[:n] if n is not None else vals
        return self.par.get_array(key, typ, n)
