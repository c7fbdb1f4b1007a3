"""Update-topic messaging: the in-process and file:// broker."""
