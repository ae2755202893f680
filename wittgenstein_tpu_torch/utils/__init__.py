"""Host-side helpers of the port: stats getters and the measurement
protocol."""
