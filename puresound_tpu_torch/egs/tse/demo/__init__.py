"""The TSE demos on the port: a file streamed at real-time cadence
(`demo_app`), simulated microphones through the serving loop
(`live_demo`) and the live-microphone app (`mic_demo`)."""
