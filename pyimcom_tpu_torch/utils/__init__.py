"""Host-side utilities of the port: adaptive moments."""
