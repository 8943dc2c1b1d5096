"""Training: the train step, Adam and its schedule, the round loop, the
device training pools, the evaluator, metrics and checkpoints."""
