"""Training: the train step, Adam and its schedule, the round loop, the
evaluator, metrics and checkpoints."""
