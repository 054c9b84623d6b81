"""Data model: channel layouts and variable registries (numpy)."""
