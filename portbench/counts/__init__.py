"""Part of the port's benchmark (portbench/README.md)."""
