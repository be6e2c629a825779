"""Signal-processing stages of both pipeline branches (torch and host numpy)."""
