"""Plain PyTorch versions of the ssm_scan kernel: the exact step recurrence
(the oracle) and the chunk-parallel form (the CPU path of ``ops.ssm_scan``).

Re-exported from ``repro_torch.models.ssm``, so the kernel's oracle and the
model's plain path are the same code, as in the reference's ``ref.py``.
"""

from ...models.ssm import ssm_scan_chunked as ssm_scan_chunked  # noqa: F401
from ...models.ssm import ssm_scan_ref as ssm_scan_ref  # noqa: F401
