"""The streaming plane of the PyTorch port: so far the host plane that
mutation cohorts escalate to (``batcher.escalate_rows``)."""
from repro_torch.stream.batcher import escalate_rows

__all__ = ["escalate_rows"]
