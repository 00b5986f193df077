"""Report model and printers."""
