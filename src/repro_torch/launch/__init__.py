"""Command-line entry points of the port (serve, train, the dry run and its
report), the device meshes, and the roofline and HBM-traffic models."""
