"""Real-robot serving of the port (launcher for the HTTP server), the
"realworld" env (`env.RealWorldEnv`, registered when its module is
imported) and the Agilex hardware glue (`agilex`: the RealSense camera,
the ROS base controller and the observation recorder, whose hardware
imports stay inside their constructors)."""
