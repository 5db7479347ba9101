"""The frozen yardstick of the roofline shares."""
