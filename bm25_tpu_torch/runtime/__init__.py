"""Device session, health probes and profiling hooks of the PyTorch port."""

from bm25_tpu_torch.runtime.session import (Session, accelerator_count,
                                            get_device, get_session)

__all__ = ["Session", "accelerator_count", "get_device", "get_session"]
