"""Plugin system: external packages extend a node with new request handlers.

Reference behavior: plenum/server/plugin_loader.py + the PLUGIN_ROOT
convention (plenum/config.py PluginsToLoad) and the demo plugins under
plenum/test/plugin (AUCTION/BANK): a plugin ships write/read request
handlers that the node registers at bootstrap, giving it new txn types
without touching core code.

A plugin is any object (usually a module) exposing:

    get_write_handlers(db) -> iterable of WriteRequestHandler   (optional)
    get_read_handlers(db)  -> iterable of read handlers         (optional)
    init(node)             -> called once the Node exists       (optional)

Plugins are passed to NodeBootstrap(plugins=[...]) or registered globally
via register_plugin() before bootstrap (the import-side-effect style the
reference's PLUGIN_ROOT loading has).
"""
from __future__ import annotations

import importlib
from typing import Any, Iterable, Optional

_GLOBAL_PLUGINS: list[Any] = []


def register_plugin(plugin: Any) -> None:
    """Register for every subsequently-bootstrapped node."""
    if plugin not in _GLOBAL_PLUGINS:
        _GLOBAL_PLUGINS.append(plugin)


def unregister_plugin(plugin: Any) -> None:
    if plugin in _GLOBAL_PLUGINS:
        _GLOBAL_PLUGINS.remove(plugin)


def registered_plugins() -> list[Any]:
    return list(_GLOBAL_PLUGINS)


def load_plugin(module_path: str) -> Any:
    """Import a plugin by dotted module path and register it."""
    plugin = importlib.import_module(module_path)
    register_plugin(plugin)
    return plugin


def install_plugins(db, write_manager, read_manager,
                    plugins: Optional[Iterable[Any]] = None) -> list[Any]:
    """Bootstrap hook: register every plugin's handlers. Returns the
    effective plugin list (explicit + global)."""
    effective = list(plugins or []) + [p for p in _GLOBAL_PLUGINS
                                       if p not in (plugins or [])]
    for plugin in effective:
        for handler in (getattr(plugin, "get_write_handlers",
                                lambda _db: [])(db) or []):
            write_manager.register_handler(handler)
        for handler in (getattr(plugin, "get_read_handlers",
                                lambda _db: [])(db) or []):
            read_manager.register_handler(handler)
    return effective


def init_plugins(node, plugins: Iterable[Any]) -> None:
    """Node hook: give plugins a chance to see the built node."""
    for plugin in plugins:
        init = getattr(plugin, "init", None)
        if init is not None:
            init(node)
