"""RAII-style resource guard (copy of ash_tpu/render/safe_resource.py;
reference src/renderer/resources/safe_resource.rs): wraps a value with a cleanup
closure run exactly once on close/del/scope-exit."""

from __future__ import annotations

from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class SafeResource(Generic[T]):
    def __init__(self, value: T, cleanup: Callable[[T], None], name: str = ""):
        self._value: Optional[T] = value
        self._cleanup = cleanup
        self.name = name

    @property
    def value(self) -> T:
        if self._value is None:
            raise RuntimeError(f"SafeResource {self.name!r} already released")
        return self._value

    def release(self) -> Optional[T]:
        """Take ownership without running cleanup."""
        v, self._value = self._value, None
        return v

    def close(self) -> None:
        if self._value is not None:
            v, self._value = self._value, None
            self._cleanup(v)

    def __enter__(self) -> T:
        return self.value

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
