"""In-memory logger with levels and a bounded tail view.

Rebuild of the reference's mutex-guarded `Logger`
(`code/include/server/Logger.hpp:19-71`, `code/server/server/Logger.cpp:11-63`):
four levels, timestamps, and `get()` returning the last <= 50 messages.
Also mirrors to Python's std logging so CLI users get console output."""
from __future__ import annotations

import enum
import logging
import threading
import time
from dataclasses import dataclass
from typing import List

_pylog = logging.getLogger("nrenderer_torch")


class LogType(enum.Enum):
    LOG = 0
    WARNING = 1
    ERROR = 2
    SUCCESS = 3


@dataclass
class LogMessage:
    type: LogType
    content: str
    timestamp: float


class Logger:
    TAIL = 50  # reference caps `get()` at 50 (`Logger.cpp:45-60`)

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._messages: List[LogMessage] = []

    def _add(self, type_: LogType, content: str) -> None:
        msg = LogMessage(type_, content, time.time())
        with self._lock:
            self._messages.append(msg)
        level = {LogType.LOG: logging.INFO, LogType.WARNING: logging.WARNING,
                 LogType.ERROR: logging.ERROR,
                 LogType.SUCCESS: logging.INFO}[type_]
        _pylog.log(level, content)

    def log(self, content: str) -> None:
        self._add(LogType.LOG, content)

    def warning(self, content: str) -> None:
        self._add(LogType.WARNING, content)

    def error(self, content: str) -> None:
        self._add(LogType.ERROR, content)

    def success(self, content: str) -> None:
        self._add(LogType.SUCCESS, content)

    def clear(self) -> None:
        with self._lock:
            self._messages.clear()

    def get(self) -> List[LogMessage]:
        """Last <= 50 messages, oldest first."""
        with self._lock:
            return list(self._messages[-self.TAIL:])
