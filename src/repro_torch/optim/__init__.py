"""AdamW with float32 master weights, and learning-rate schedules."""
