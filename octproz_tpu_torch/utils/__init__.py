"""Host-side utilities: device-memory preflight and fidelity metrics."""
