"""A model module that names the built-in model's functions: a
configuration that names it is served and checked as one without a
``model`` key."""
from bench.model import desc_from_file as desc  # noqa: F401
from bench.reference import logits_at  # noqa: F401
from bench.weights import make_params  # noqa: F401
