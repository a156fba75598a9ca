"""Operations and bytes per layer, and the card's peaks: the yardstick of
the roofline and utilization metrics."""
