"""Config schemas of the port (pydantic, copied from internnav_tpu.configs)."""
