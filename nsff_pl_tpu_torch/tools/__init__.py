"""The port's tools (counterparts of the repo-root `tools/*.py`):
`profile_step`, `save_weights_only` and `export_render`."""
