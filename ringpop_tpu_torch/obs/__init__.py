"""Host halves of the obs planes (decoders of device-side records)."""
