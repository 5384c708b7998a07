"""Host-side utilities of the port: adaptive moments, SCA-to-SCA geometry."""
