"""Training substrate of the port: AdamW, checkpoints, the restartable
trainer, over the port's dict/list param trees."""
