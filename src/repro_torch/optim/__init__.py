"""repro_torch.optim — AdamW and learning-rate schedules (port of
`repro.optim`)."""
from repro_torch.optim import adamw, schedule

__all__ = ["adamw", "schedule"]
