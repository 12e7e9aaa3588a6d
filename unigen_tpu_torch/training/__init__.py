"""Training: schedules, AdamW, EMA, the pretraining step and Trainer, SFT, DPO, LoRA and
their entry points."""
