"""Training substrate of the port: the AdamW optimizer and its schedule, the
train step and the ``Trainer`` (``train_loop``)."""
