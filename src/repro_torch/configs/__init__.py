"""Architecture registry and model configurations."""
