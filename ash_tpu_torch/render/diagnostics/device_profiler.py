"""Device profiler: named scopes timed on the device (port of
ash_tpu/render/diagnostics/device_profiler.py).

A scope measures the host time from its start to the moment the device has
finished the work issued inside it: it closes with
`torch.cuda.synchronize(device)` on a CUDA device (PyTorch runs eagerly, so
on the CPU the work is done when the call returns). A synchronise
serialises the stream, so sampling is throttled: scopes measure every
`sample_interval` frames and report the last sample in between, as the
reference's stale-cache fallback does. For kernel-level traces,
`start_trace` / `stop_trace` wrap `torch.profiler` (the chrome trace is
written to the log directory).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch

from ...device import resolve_device

# Named scopes (reference gpu_profiler.rs:25-64).
SCOPES = (
    "FrameStart",
    "ShadowEnd",
    "SceneEnd",
    "BloomThreshold",
    "BloomDownsample",
    "BloomUpsample",
    "PostProcessEnd",
    "UiEnd",
    "FrameEnd",
)


def _fence(device: torch.device) -> None:
    """Wait until `device` has run everything issued so far."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ProfileScope:
    def __init__(self, profiler: "DeviceProfiler", name: str):
        self.profiler = profiler
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.profiler._sampling:
            _fence(self.profiler.device)
            self.profiler._samples[self.name] = (
                time.perf_counter() - self.t0
            ) * 1000.0
        return False


class DeviceProfiler:
    def __init__(self, sample_interval: int = 30, enabled: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.enabled = enabled
        self.sample_interval = sample_interval
        self._frame = 0
        self._sampling = False
        self._samples: Dict[str, float] = {}
        self._trace: Optional[torch.profiler.profile] = None
        self._trace_dir: Optional[str] = None

    def begin_frame(self) -> None:
        self._frame += 1
        self._sampling = (
            self.enabled and self._frame % self.sample_interval == 0
        )

    def scope(self, name: str) -> ProfileScope:
        return ProfileScope(self, name)

    @contextmanager
    def pass_scope(self, name: str, value):
        """Time a pass up to the device finishing it, when sampling."""
        t0 = time.perf_counter()
        yield
        if self._sampling and value is not None:
            _fence(self.device)
            self._samples[name] = (time.perf_counter() - t0) * 1000.0

    def timings_ms(self) -> Dict[str, float]:
        """Last known per-scope times (cached between samples)."""
        return dict(self._samples)

    # torch.profiler integration (deep traces).
    def start_trace(self, log_dir: str) -> None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._trace = torch.profiler.profile(activities=activities)
        self._trace.__enter__()
        self._trace_dir = log_dir

    def stop_trace(self) -> None:
        _fence(self.device)
        self._trace.__exit__(None, None, None)
        os.makedirs(self._trace_dir, exist_ok=True)
        self._trace.export_chrome_trace(
            os.path.join(self._trace_dir, "trace.json"))
        self._trace = None
        self._trace_dir = None
