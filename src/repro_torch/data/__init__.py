"""The synthetic LM token pipeline (port of ``repro/data``)."""
from repro_torch.data.tokens import SyntheticLMData, batch_iterator

__all__ = ["SyntheticLMData", "batch_iterator"]
