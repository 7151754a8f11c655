"""ComponentManager: async renderer execution with a state machine.

Rebuild of the reference `ComponentManager`
(`code/app/include/manager/ComponentManager.hpp:19-70`): `exec(info, scene)`
creates the component via the factory and runs `RenderComponent.exec` on a
background thread with state transitions IDLING -> READY -> RUNNING -> FINISH
and catches unexpected termination (`ComponentManager.hpp:46-63`); the
reference's wall clock is the renderers' spans (`utils/timing.py`).  Unlike
the reference's detached thread, the thread is joinable (`wait()`), and
errors are captured rather than lost."""
from __future__ import annotations

import enum
import threading
from typing import Optional

from ..scene.model import Scene
from .component import RenderComponent, RenderResult
from .registry import get_server


class State(enum.Enum):
    IDLING = 0
    READY = 1
    RUNNING = 2
    FINISH = 3


class ComponentManager:
    def __init__(self) -> None:
        self._state = State.IDLING
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._result: Optional[RenderResult] = None
        self._error: Optional[BaseException] = None

    @property
    def state(self) -> State:
        with self._lock:
            return self._state

    @property
    def result(self) -> Optional[RenderResult]:
        with self._lock:
            return self._result

    @property
    def error(self) -> Optional[BaseException]:
        with self._lock:
            return self._error

    def _set_state(self, s: State) -> None:
        with self._lock:
            self._state = s

    def exec(self, name: str, scene: Scene,
             component: Optional[RenderComponent] = None) -> None:
        """Launch renderer `name` (registered type "Render") on a thread."""
        if self.state in (State.READY, State.RUNNING):
            raise RuntimeError("A component is already running")
        comp = component or get_server().component_factory.create_component(
            "Render", name)
        self._set_state(State.READY)
        with self._lock:
            self._result = None
            self._error = None

        def on_start():
            with self._lock:
                self._state = State.RUNNING

        def on_finish():
            with self._lock:
                self._state = State.FINISH

        def run():
            try:
                result = comp.exec(on_start, on_finish, scene)
                with self._lock:
                    self._result = result
            except BaseException as exc:  # reference: "Unexpected termination"
                get_server().logger.error(f"Unexpected termination: {exc!r}")
                with self._lock:
                    self._error = exc
                    self._state = State.FINISH

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self, timeout: Optional[float] = None) -> Optional[RenderResult]:
        if self._thread is not None:
            self._thread.join(timeout)
        if self.state == State.FINISH:
            self._set_state(State.IDLING)
        if self.error is not None:
            raise self.error
        return self.result
