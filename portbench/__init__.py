"""The port's benchmark: one cell (a configuration under a traffic mix)
per run, driven by the files under this folder (see README.md)."""
