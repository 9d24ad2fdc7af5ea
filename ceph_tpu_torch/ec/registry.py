"""Erasure-code plugin registry.

Behavioral twin of ``ErasureCodePluginRegistry``
(reference src/erasure-code/ErasureCodePlugin.{h,cc}):

- process-wide singleton (``instance``);
- ``factory(name, profile)`` loads the plugin on first use, builds a
  code instance, and cross-checks the instance's stored profile against
  the requested one (ErasureCodePlugin.cc:86-114);
- plugins live in importable modules (the ``dlopen(libec_<name>.so)``
  analogue is ``importlib.import_module(f"{directory}.{name}")``,
  ErasureCodePlugin.cc:120-178) and must expose a module-level
  ``__erasure_code_init__(name, registry)`` entry point that calls
  ``registry.add(name, plugin)``, plus ``__erasure_code_version__``
  matching the framework version (the CEPH_GIT_NICE_VER check);
- ``preload(plugins)`` loads a comma/space-separated list at daemon
  start (ErasureCodePlugin.cc:180-196, driven by the
  ``osd_erasure_code_plugins`` option);
- ``factory(..., device=...)`` hands a torch device to plugins that run
  on one (the ``cuda`` plugin); without it they take their default.

Load failures map to the same errnos the reference returns: EIO
(missing/broken module), EXDEV (version mismatch), ENOENT (no entry
point), EBADF (entry point didn't register).
"""

from __future__ import annotations

import errno
import importlib
import re
import threading
from typing import Callable

from ceph_tpu_torch import __version__
from ceph_tpu_torch.ec.interface import ECError, ErasureCodeInterface

DEFAULT_PLUGIN_DIRECTORY = "ceph_tpu_torch.ec.plugins"

PLUGIN_INIT_FUNCTION = "__erasure_code_init__"
PLUGIN_VERSION_ATTR = "__erasure_code_version__"


class ErasureCodePlugin:
    """Base for plugin objects: a named factory of code instances
    (reference ErasureCodePlugin.h ErasureCodePlugin::factory)."""

    def __init__(self, factory: Callable[[dict], ErasureCodeInterface] | None = None):
        self._factory = factory

    def factory(self, profile: dict, **kwargs) -> ErasureCodeInterface:
        if self._factory is None:
            raise NotImplementedError
        ec = self._factory(profile, **kwargs)
        ec.init(profile)
        return ec


class ErasureCodePluginRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._plugins: dict[str, ErasureCodePlugin] = {}
        self.loading = False
        self.disable_dlclose = False  # parity knob; unloading never happens

    # -- registration (called from plugin __erasure_code_init__) ------------

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        if name in self._plugins:
            raise ECError(errno.EEXIST, f"plugin {name} already registered")
        self._plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin | None:
        return self._plugins.get(name)

    def remove(self, name: str) -> None:
        self._plugins.pop(name, None)

    # -- loading -------------------------------------------------------------

    def load(self, plugin_name: str, directory: str = DEFAULT_PLUGIN_DIRECTORY) -> ErasureCodePlugin:
        """Import + handshake a plugin module (ErasureCodePlugin.cc:120-178)."""
        if not re.fullmatch(r"[A-Za-z0-9_]+", plugin_name):
            raise ECError(errno.EIO, f"invalid plugin name {plugin_name!r}")
        modname = f"{directory}.{plugin_name}"
        try:
            mod = importlib.import_module(modname)
        except ImportError as e:
            raise ECError(errno.EIO, f"load import({modname}): {e}") from e
        version = getattr(mod, PLUGIN_VERSION_ATTR, "an older version")
        if version != __version__:
            raise ECError(
                errno.EXDEV,
                f"expected plugin {modname} version {__version__} "
                f"but it claims to be {version} instead",
            )
        init = getattr(mod, PLUGIN_INIT_FUNCTION, None)
        if init is None:
            raise ECError(
                errno.ENOENT, f"load getattr({modname}, {PLUGIN_INIT_FUNCTION})"
            )
        try:
            init(plugin_name, self)
        except ECError:
            raise
        except Exception as e:
            raise ECError(errno.EIO, f"{PLUGIN_INIT_FUNCTION}({plugin_name}): {e}") from e
        plugin = self.get(plugin_name)
        if plugin is None:
            raise ECError(
                errno.EBADF,
                f"load {PLUGIN_INIT_FUNCTION}() did not register {plugin_name}",
            )
        return plugin

    def factory(
        self,
        plugin_name: str,
        profile: dict,
        directory: str = DEFAULT_PLUGIN_DIRECTORY,
        *,
        device=None,
    ) -> ErasureCodeInterface:
        """Load-if-needed then instantiate; verifies the instance kept the
        profile (ErasureCodePlugin.cc:86-114).  ``device`` goes to the
        plugin's factory when given."""
        with self._lock:
            plugin = self.get(plugin_name)
            if plugin is None:
                self.loading = True
                try:
                    plugin = self.load(plugin_name, directory)
                finally:
                    self.loading = False
        # reference semantics (ErasureCodePlugin.cc:105-112): ``profile``
        # is mutated in place by parsing (defaults injected), the plugin
        # stores a copy, and the two must match exactly afterwards
        ec = (plugin.factory(profile) if device is None
              else plugin.factory(profile, device=device))
        if ec.get_profile() != profile:
            raise ECError(
                errno.EINVAL,
                f"factory profile {profile} != get_profile() {ec.get_profile()}",
            )
        return ec

    def preload(self, plugins: str, directory: str = DEFAULT_PLUGIN_DIRECTORY) -> None:
        """ErasureCodePlugin.cc:180-196."""
        with self._lock:
            for name in re.split(r"[,\s]+", plugins.strip()):
                if name and self.get(name) is None:
                    self.load(name, directory)


#: process-wide singleton (ErasureCodePlugin.cc:36 instance())
instance = ErasureCodePluginRegistry()
