"""Deprecated name of the ``bert4clickpath`` package, kept so that code
written against it still imports. ``import <this>.x.y`` returns the module
``bert4clickpath.x.y`` itself (the same objects, not copies) and warns once.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

import bert4clickpath

_NEW = bert4clickpath.__name__


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves every submodule of this package to the module of the same
    path under ``bert4clickpath``."""

    def find_spec(self, name, path=None, target=None):
        if name.startswith(__name__ + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        # the import system returns whatever sys.modules holds for the name
        sys.modules[module.__name__] = importlib.import_module(
            _NEW + module.__name__[len(__name__):]
        )


warnings.warn(
    f"the package name {__name__!r} is deprecated; import {_NEW!r}",
    DeprecationWarning,
    stacklevel=2,
)
sys.meta_path.insert(0, _Alias())
sys.modules[__name__] = bert4clickpath
