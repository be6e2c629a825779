"""Host-side I/O of the streaming runtime: acquisition sources, recorders
and volume assembly (numpy only; nothing here touches the device)."""
