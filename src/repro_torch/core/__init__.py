"""Framework-free control plane plus the device-resident pool and
instance of the port (reference: ``repro/core``)."""
