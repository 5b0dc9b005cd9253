"""Single-device training: train step, checkpoint/restart loop."""
