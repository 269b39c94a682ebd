"""Training: AdamW (``optim``) and the train-step assembly (``step``)."""
