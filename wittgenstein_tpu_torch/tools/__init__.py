"""Host-side output tools of the port: CSV rows, line plots and node
maps.  Plotting imports matplotlib and drawing imports PIL only inside
the calls that need them; importing these modules loads neither."""
