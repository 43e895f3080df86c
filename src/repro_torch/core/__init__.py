"""Host-side EPD-Serve machinery, copied from the reference."""
