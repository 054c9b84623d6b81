"""GenCast model, sampler and wrappers."""
