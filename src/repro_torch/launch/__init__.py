"""Launch-time hardware description: the card's ``HardwareSpec`` roofline."""
