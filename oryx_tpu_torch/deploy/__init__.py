"""Deploy tier: the layer mains and the operator CLI (reference:
deploy/oryx-{batch,speed,serving}/.../Main.java + deploy/bin/oryx-run.sh)."""
