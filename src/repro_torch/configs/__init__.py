"""Registry of supported model configurations."""
