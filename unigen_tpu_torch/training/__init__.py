"""The unified pretraining path: schedules, AdamW, EMA, the train step and the Trainer."""
