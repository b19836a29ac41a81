"""Matrix file readers and writers (host numpy)."""
