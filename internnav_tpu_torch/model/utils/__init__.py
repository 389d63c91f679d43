"""Host-side model utilities (numpy)."""
