"""Component registry — the plugin surface.

Rebuild of the reference's `ComponentFactory` + registration macros
(`code/include/component/ComponentFactory.hpp:12-44`,
`code/server/component/ComponentFactory.cpp:11-58`,
`REGISTER_RENDERER` in `RenderComponent.hpp:21-22`):

  - string-keyed (type, name) -> constructor registry
  - duplicate registration raises (reference throws `ComponentFactory.cpp:20`)
  - component id = "NR.<type>.<name>"
  - `get_components_info(type)` lists (name, description) metadata

Where the reference loads renderer DLLs whose static initializers register
themselves (`ComponentManager.cpp:15-30`), here renderer modules register at
import time via the `@register_renderer` decorator, and third-party plugins
can do the same from their own packages."""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple


class DuplicateComponentError(RuntimeError):
    pass


class UnknownComponentError(KeyError):
    pass


@dataclass(frozen=True)
class ComponentInfo:
    type: str
    name: str
    description: str = ""

    @property
    def id(self) -> str:
        return f"NR.{self.type}.{self.name}"


@dataclass
class _Entry:
    info: ComponentInfo
    ctor: Callable


class ComponentFactory:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str], _Entry] = {}

    def register_component(self, type_: str, name: str, description: str,
                           ctor: Callable) -> None:
        key = (type_, name)
        with self._lock:
            if key in self._entries:
                raise DuplicateComponentError(
                    f"Component already registered: NR.{type_}.{name}")
            self._entries[key] = _Entry(
                ComponentInfo(type_, name, description), ctor)

    def unregister_component(self, type_: str, name: str) -> None:
        """DLL-unload analogue (the reference unregisters in the static
        object's destructor, `Component.hpp:23-34`)."""
        with self._lock:
            self._entries.pop((type_, name), None)

    def create_component(self, type_: str, name: str):
        with self._lock:
            entry = self._entries.get((type_, name))
        if entry is None:
            raise UnknownComponentError(f"NR.{type_}.{name}")
        return entry.ctor()

    def get_components_info(self, type_: str = "") -> List[ComponentInfo]:
        with self._lock:
            infos = [e.info for e in self._entries.values()
                     if not type_ or e.info.type == type_]
        return sorted(infos, key=lambda i: i.id)


def register_renderer(name: str, description: str = ""):
    """Decorator: register a RenderComponent subclass (or zero-arg factory)
    under type "Render" — the analogue of `REGISTER_RENDERER(Adapter, name,
    description)`."""
    def deco(cls):
        get_server().component_factory.register_component(
            "Render", name, description, cls)
        cls.component_info = ComponentInfo("Render", name, description)
        return cls
    return deco


# ---------------------------------------------------------------------------
# Server singleton: the process-global service hub (`Server.hpp:11-23`).
# ---------------------------------------------------------------------------

@dataclass
class Server:
    logger: "Logger" = field(default_factory=lambda: _make_logger())
    screen: "Screen" = field(default_factory=lambda: _make_screen())
    component_factory: ComponentFactory = field(default_factory=ComponentFactory)


def _make_logger():
    from .logger import Logger
    return Logger()


def _make_screen():
    from .screen import Screen
    return Screen()


_server: Server = None
_server_lock = threading.Lock()


def get_server() -> Server:
    """`getServer()` (`Server.cpp:3-6`): lazily constructed process singleton."""
    global _server
    if _server is None:
        with _server_lock:
            if _server is None:
                _server = Server()
    return _server
