"""Error types for ash_tpu_torch (a copy of ash_tpu/errors.py).

TPU-native re-design of the reference error enum (reference: src/error.rs:12-29).
The reference has 8 variants driving control flow; the only one that matters for
the frame loop is ``SwapchainOutOfDate`` (resize). On TPU a "swapchain loss" is a
resolution change, which simply re-specializes the jitted frame function, but we
keep the error taxonomy so application code ports over unchanged.
"""

from __future__ import annotations


class AshError(Exception):
    """Base error for the renderer (reference: src/error.rs:12)."""


class VulkanError(AshError):
    """Generic backend failure (reference: src/error.rs `VulkanError`).

    On TPU this wraps XLA/JAX runtime errors.
    """


class SwapchainOutOfDate(AshError):
    """The output surface size changed; the frame must be re-specialized.

    Reference: src/vulkan/swapchain.rs:190-236 maps ERROR_OUT_OF_DATE /
    SUBOPTIMAL to this error; the renderer responds by scheduling a resize
    (src/renderer/renderer.rs:1662-1676). Our equivalent: a shape change that
    invalidates the jit cache entry for the current extent.
    """


class ShaderCompilationError(AshError):
    """Kernel tracing/compilation failed (reference: shader compile errors)."""


class ResourceCreationError(AshError):
    """Array/buffer allocation failed."""


class InvalidOperation(AshError):
    """API misuse (e.g. unknown handle, unregistered mesh)."""


class OutOfMemory(AshError):
    """HBM exhausted."""


class DeviceLost(AshError):
    """TPU runtime failure."""
