"""Training: optimizers, the train step builders and the trainer loop."""
