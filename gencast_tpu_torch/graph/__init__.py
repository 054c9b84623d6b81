"""Host-side geometry and graph construction (numpy/scipy)."""
