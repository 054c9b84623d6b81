"""Ranks and ensembles for the port: process groups over (ensemble, data,
model) (`meshes`), and ensemble forecasts on one device or sharded over
ranks (`ensemble`)."""
