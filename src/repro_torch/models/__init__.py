"""Dense attention transformer: config, layers, paged attention, model."""
