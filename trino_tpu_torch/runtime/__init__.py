"""Runtime supervision: the crash-containment boundary around the card.

Counterpart of trino_tpu/runtime/.  ``runtime/supervisor.py`` owns the
supervised boundary — every kernel launch of ops/kernels.py, every
operator visit and every device->host sync of exec/local.py crosses it,
so a device loss or wedge is attributed (a breadcrumb naming the culprit
kernel) and contained (device quarantine, then blacklist).  The query
fails with DeviceFaultError: nothing re-runs it on the CPU.
"""
from .supervisor import (  # noqa: F401
    Breadcrumb,
    DeviceFaultError,
    DeviceSupervisor,
    default_supervisor,
    last_breadcrumb,
)
